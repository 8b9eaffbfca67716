"""Kernel K1 (pygemma_tpu_torch/ops/gram_kernel.py) and its plain version.

On the CPU the wrapper runs the plain PyTorch version; it is held here to
the JAX package's Pallas kernel (interpret mode, as tests/test_pallas_kernel.py
runs it).  The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py); its launch geometry and row layout are held
here by a NumPy emulation of the kernel's partial-sum / reduce scheme.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pygemma_tpu.core.grams import grams_per_snp_lambda_fused as jax_fused
from pygemma_tpu.core.grams import pair_products as jax_pairs
from pygemma_tpu_torch.core.grams import pair_products
from pygemma_tpu_torch.ops import gram_kernel as gk

torch.set_num_threads(2)


def _data(n, B, c, R=None, seed=None):
    rng = np.random.default_rng(n * 1000 + B if seed is None else seed)
    ev = np.abs(rng.normal(size=n)).astype(np.float32)
    W = rng.normal(size=(n, c)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    X = rng.normal(size=(n, B)).astype(np.float32)
    size = B if R is None else (B, R)
    lam = np.power(10.0, rng.uniform(-4, 4, size=size)).astype(np.float32)
    return ev, np.c_[W, y], X, lam


def _torch_fused(ev, shared, X, lam, kmax, want_logh):
    sh = torch.as_tensor(shared)
    return gk.fused_grams(torch.as_tensor(lam), torch.as_tensor(ev),
                          pair_products(sh), sh, torch.as_tensor(X), kmax,
                          want_logh)


def _as_grams(res, s):
    """fused_grams tuple -> the Gram tensors grams_per_snp_lambda_fused
    assembles (so the comparison uses test_pallas_kernel.py's form)."""
    from pygemma_tpu_torch.core.grams import _assemble_nd, unpack_sym

    S, vS, vv = res[:3]
    return [_assemble_nd(unpack_sym(S[..., k, :], s), vS[..., k, :],
                         vv[..., k]).numpy() for k in range(S.shape[-2])]


@pytest.mark.parametrize("n,B,c,R", [(300, 40, 3, None), (70, 10, 1, None),
                                     (515, 130, 6, None), (260, 24, 2, 2)])
@pytest.mark.parametrize("want_logh", [False, True])
def test_reference_matches_jax_kernel(n, B, c, R, want_logh):
    from jax.experimental.pallas import tpu as pltpu

    ev, shared, X, lam = _data(n, B, c, R)
    s = shared.shape[1]
    sj = jnp.asarray(shared)
    with pltpu.force_tpu_interpret_mode():
        gj, sums_j = jax_fused(jnp.asarray(lam), jnp.asarray(ev), sj,
                               jax_pairs(sj), jnp.asarray(X), (1, 2, 3),
                               want_logh=want_logh)
    res = _torch_fused(ev, shared, X, lam, 3, want_logh)
    # the JAX kernel's dots are split bf16x3 (~2^-16 operand rounding): the
    # tolerance is test_pallas_kernel.py's
    for got, ref in zip(_as_grams(res, s), gj):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=2e-4,
                                   atol=3e-4 * np.abs(ref).max())
    np.testing.assert_allclose(res[3].numpy(), sums_j.sum_d, rtol=1e-5)
    np.testing.assert_allclose(res[4].numpy(), sums_j.sum_d2, rtol=1e-5)
    np.testing.assert_allclose(res[5].numpy(), sums_j.sum_logh, rtol=1e-5,
                               atol=1e-5)


def test_wrapper_contract_on_cpu():
    """kmax=1 zeroes sum_d2, no logh zeroes sum_logh, float64 inputs come
    back float32, and the CPU path launches nothing."""
    ev, shared, X, lam = _data(50, 6, 2)
    before = gk.fused_grams.launches
    res = _torch_fused(ev.astype(np.float64), shared.astype(np.float64),
                       X.astype(np.float64), lam.astype(np.float64), 1, False)
    assert gk.fused_grams.launches == before
    assert all(t.dtype == torch.float32 for t in res)
    S, vS, vv, sd, sd2, lh = res
    assert S.shape == (6, 1, 6) and vS.shape == (6, 1, 3) and vv.shape == (6, 1)
    assert not sd2.any() and not lh.any() and sd.all()


def test_wrapper_refuses_other_devices():
    ev, shared, X, lam = _data(20, 4, 1)
    meta = [torch.empty(a.shape, device="meta") for a in (lam, ev, X)]
    sh = torch.empty(shared.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gk.fused_grams(meta[0], meta[1], pair_products(sh), sh, meta[2], 2)
    with pytest.raises(ValueError, match="kmax"):
        _torch_fused(ev, shared, X, lam, 4, False)


def _emulate_kernel(lam, ev, pairs, shared, v, kmax, want_logh, sm=132):
    """NumPy model of csrc/gram_kernel.cu: feature layout, sample splits and
    feature chunks from launch_plan, partial rows, fixed-order reduce.
    Returns the (rows, B, R) array the wrapper's _split_rows reads."""
    n, B = v.shape
    R = lam.shape[1]
    m, s = pairs.shape[1], shared.shape[1]
    F = m + s + 2
    nsplit, span, rows = gk.launch_plan(n, B, R, m, s, kmax, sm)
    base = np.concatenate([pairs, np.ones((n, 1)), shared, np.ones((n, 1))],
                          axis=1)  # (n, F)
    kind = np.array([0] * (m + 1) + [1] * s + [2])
    part = np.zeros((nsplit, rows, B, R))
    for sp in range(nsplit):
        sl = slice(sp * span, min(n, (sp + 1) * span))
        h = lam[None, :, :] * ev[sl, None, None] + 1.0  # (ns, B, R)
        d = 1.0 / h
        x = v[sl][:, :, None]
        mult = np.stack([np.ones_like(x), x, x * x])  # (3, ns, B, 1)
        for k in range(kmax):
            for f in range(F):
                t = base[sl, f][:, None, None] * mult[kind[f]]
                part[sp, k * F + f] = np.sum(d ** (k + 1) * t, axis=0)
        if want_logh:
            part[sp, kmax * F] = np.sum(np.log(h), axis=0)
    return part.sum(axis=0)


@pytest.mark.parametrize("n,B,c,R,kmax,want_logh", [
    (1000, 40, 3, 1, 3, True), (999, 30, 10, 2, 2, False),
    (300, 9, 1, 1, 1, True), (2100, 64, 6, 1, 3, False)])
def test_kernel_layout_matches_reference(n, B, c, R, kmax, want_logh):
    ev, shared, X, lam = _data(n, B, c, R, seed=5)
    lam2 = lam[:, None] if lam.ndim == 1 else lam
    pairs = pair_products(torch.as_tensor(shared)).numpy()
    rows = _emulate_kernel(lam2.astype(np.float64), ev.astype(np.float64),
                           pairs.astype(np.float64),
                           shared.astype(np.float64), X.astype(np.float64),
                           kmax, want_logh)
    got = gk._split_rows(torch.as_tensor(rows), pairs.shape[1],
                         shared.shape[1], kmax, want_logh)
    ref = gk.fused_grams_reference(torch.as_tensor(lam2), torch.as_tensor(ev),
                                   torch.as_tensor(pairs),
                                   torch.as_tensor(shared),
                                   torch.as_tensor(X), kmax, want_logh)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == tuple(b.shape)
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30))


def test_launch_plan_fills_the_card():
    # main-path shape: 2,048 columns = 16 blocks; the sample axis is split
    # so the grid holds ~4 blocks per SM, each split a whole number of tiles
    nsplit, span, rows = gk.launch_plan(10000, 2048, 1, 10, 4, 3, 132)
    assert rows == 3 * 16 + 1
    assert span % 64 == 0 and span >= 256
    assert nsplit * span >= 10000 > (nsplit - 1) * span
    assert nsplit * 16 >= 3 * 132  # rounding to whole tiles costs a few
    # tiny problems never split below one tile of samples
    assert gk.launch_plan(70, 10, 1, 1, 2, 1, 132)[0] == 1


def test_bound_at_main_path_shape():
    flops, nbytes = gk.flops_and_bytes(10000, 2048, 1, 10, 4, 3, False)
    ms, by = gk.bound_ms(flops, nbytes)
    assert by == "operations"
    assert 0.025 < ms < 0.04  # ~2.1 GFLOP at 67 TFLOP/s
    ms1, by1 = gk.bound_ms(*gk.flops_and_bytes(10000, 2048, 1, 10, 4, 1,
                                               False))
    assert by1 == "bytes" and ms1 < ms
