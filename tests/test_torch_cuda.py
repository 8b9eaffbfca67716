"""Cases that need a CUDA card: the hand-written kernel against its plain
version, the pinned-buffer streamer, and the scan on the card against the
scan on the CPU.

The module imports neither jax nor pygemma_tpu, so on a machine with a card
it runs without the JAX-configuring conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

Without a card every case skips.
"""

import numpy as np
import pytest
import torch

import oracle
import pygemma_tpu_torch as pt
from pygemma_tpu_torch.core.grams import pair_products
from pygemma_tpu_torch.io.streaming import SnpBlockStreamer
from pygemma_tpu_torch.ops import gram_kernel as gk

pytestmark = pytest.mark.gpu

FLOWS = {
    "lrt_score": {"tests": ("wald", "lrt", "score")},
    "de": {"de": True},
    "grid": {"grid": True},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data():
    y, G, W, K = oracle.simulate(n=220, p=40, c=3, seed=5)
    G[:, 7] = 0.0  # constant SNP: a full NaN row
    return y, G, W, K


def _kernel_inputs(n, B, c, R, device, lam_pows=(-4, 4)):
    rng = np.random.default_rng(n * 1000 + B)
    ev = np.abs(rng.normal(size=n)).astype(np.float32)
    ev[:20] *= 1e3  # a few large eigenvalues, as a kinship spectrum has
    shared = rng.normal(size=(n, c + 1)).astype(np.float32)
    X = rng.normal(size=(n, B)).astype(np.float32)
    size = B if R == 1 else (B, R)
    lam = np.power(10.0, rng.uniform(*lam_pows, size=size)).astype(np.float32)
    sh = torch.as_tensor(shared, device=device)
    return (torch.as_tensor(lam, device=device),
            torch.as_tensor(ev, device=device), pair_products(sh), sh,
            torch.as_tensor(X, device=device))


def _check_against_plain(args, kmax, want_logh):
    before = gk.fused_grams.launches
    got = gk.fused_grams(*args, kmax, want_logh)
    torch.cuda.synchronize()
    assert gk.fused_grams.launches == before + 1
    ref = gk.fused_grams_reference(*args, kmax, want_logh)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        b = b.cpu().numpy()
        # float32 sums in another order: the plain version's own rounding
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("c,R,kmax,want_logh", [
    (3, 1, 3, False), (3, 1, 1, True), (10, 2, 2, True), (1, 1, 3, True)])
def test_kernel_matches_plain(cuda, c, R, kmax, want_logh):
    # n = 4,099 is no whole number of 32-sample stages, B = 300 no whole
    # number of 128-column blocks (and not a multiple of 4: 4-byte copies)
    _check_against_plain(_kernel_inputs(4099, 300, c, R, cuda), kmax,
                         want_logh)


@pytest.mark.parametrize("n,B,c,R,kmax", [
    (4099, 17, 3, 1, 3), (4099, 17, 3, 3, 2), (4096, 256, 3, 1, 3),
    (4099, 300, 10, 2, 3)])
def test_kernel_ragged_and_wide(cuda, n, B, c, R, kmax):
    """Ragged columns (B = 17; R = 3 leaves the 16-byte copy path), whole
    tiles with 16-byte copies, and c = 10 with R = 2 at kmax 3: 11 feature
    tiles split over three blocks."""
    _check_against_plain(_kernel_inputs(n, B, c, R, cuda), kmax, True)


@pytest.mark.parametrize("pow_", [-5, 5])
def test_kernel_extreme_lambda(cuda, pow_):
    _check_against_plain(
        _kernel_inputs(4099, 300, 3, 1, cuda, lam_pows=(pow_, pow_)), 3, True)


def test_kernel_launches_are_bit_identical(cuda):
    args = _kernel_inputs(10_000, 2048, 3, 1, cuda)
    for kmax in (1, 3):
        a = gk.fused_grams(*args, kmax, True)
        b = gk.fused_grams(*args, kmax, True)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_streamer_blocks_match_the_host(cuda):
    X = np.random.default_rng(2).normal(size=(37, 23)).astype(np.float32)
    blocks = list(SnpBlockStreamer(X, 8, device=cuda))
    assert [(a, b) for a, b, _ in blocks] == [(0, 8), (8, 16), (16, 23)]
    for start, stop, xb in blocks:
        assert xb.is_cuda and xb.shape == (37, 8)
        host = xb.cpu().numpy()
        np.testing.assert_array_equal(host[:, :stop - start], X[:, start:stop])
        assert not host[:, stop - start:].any()


@pytest.mark.parametrize("flow", list(FLOWS))
def test_scan_float64_matches_cpu(data, cuda, flow):
    cfg = pt.GwasConfig(dtype="float64", snp_block=16)
    a = pt.pygemma(*data, config=cfg, device=cuda, **FLOWS[flow])
    b = pt.pygemma(*data, config=cfg, device="cpu", **FLOWS[flow])
    assert list(a.columns) == list(b.columns)
    for col in b.columns:
        x, z = a[col].to_numpy(), b[col].to_numpy()
        np.testing.assert_array_equal(np.isnan(x), np.isnan(z), err_msg=col)
        ok = ~np.isnan(z)
        np.testing.assert_allclose(x[ok], z[ok], rtol=1e-6, atol=1e-12,
                                   err_msg=col)


def test_scan_float32_kernel_on_matches_off(data, cuda):
    """The main path through the kernel against the same path through its
    plain version, on the card."""
    cfg = pt.GwasConfig(snp_block=16)
    before = gk.fused_grams.launches
    on = pt.pygemma(*data, config=cfg, device=cuda)
    assert gk.fused_grams.launches > before
    off = pt.pygemma(*data, config=cfg.replace(use_fused_kernel=False),
                     device=cuda)
    p_on, p_off = on["p_wald"].to_numpy(), off["p_wald"].to_numpy()
    np.testing.assert_array_equal(np.isnan(p_on), np.isnan(p_off))
    ok = ~np.isnan(p_off)
    assert np.abs(np.log10(p_on[ok]) - np.log10(p_off[ok])).max() < 0.05
