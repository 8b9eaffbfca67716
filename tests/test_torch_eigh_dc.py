"""The port's spectral divide-and-conquer eigh (core/eigh_dc.py) against the
JAX package's and the dense float64 eigh.

tests/test_eigh_dc.py's seven cases run on the port with that file's
tolerances, at small ``max_block`` so the splitter recurses.  The bases
differ from the JAX package's (torch generators draw other Gaussians), so
the port is held to the JAX package on eigenvalues, certificates and
downstream statistics, never eigenvectors.  Every JAX reference is computed
in one child process; the n = 2,500 case is held to float64 NumPy alone.
Four defects of the JAX module that the port does not inherit are held
here, each by a case on which the JAX module's logic fails: a NaN range
attempt kept as the best, the repair span cut by column index, CholeskyQR2
shifted in both passes, and the range find without spare columns.  A fifth,
the float32 sign iteration, shows only at the card's n = 16,384 (chip_smoke
phase 12); here its dtype is checked.
"""

import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle
import pygemma_tpu_torch as pt
from pygemma_tpu_torch import api as tapi
from pygemma_tpu_torch.core import eigen as teigen
from pygemma_tpu_torch.core import eigh_dc as tdc
from pygemma_tpu_torch.core import lowrank as tlow

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the slice's driver flows: (n, p, tests)
DC_FLOW = dict(n=240, p=24, tests=("wald", "lrt", "score"))
MIX_MAX_BAD = 48  # 6 flagged columns at most, a repair span of 48


def _spectrum_case(n, vals, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * vals[None, :]) @ Q.T
    return ((A + A.T) / 2).astype(np.float32)


def _gram_case(n, p, seed):
    G = np.random.default_rng(seed).standard_normal((n, p)).astype(np.float32)
    return (G @ G.T / p + 1e-3 * np.eye(n)).astype(np.float32)


def _planted_mixture():
    """tests/test_eigh_dc.py's planted mixture: a 45-degree rotation
    between eigenvector columns 40 and 200 of a random spectrum."""
    rng = np.random.default_rng(5)
    n = 256
    A = _spectrum_case(n, np.sort(rng.uniform(0.5, 4.0, size=n)), 6)
    ev0, U0 = np.linalg.eigh(A.astype(np.float64))
    i, j = 40, 200
    c = np.cos(np.pi / 4)
    Um = U0.copy()
    Um[:, i] = c * U0[:, i] + c * U0[:, j]
    Um[:, j] = -c * U0[:, i] + c * U0[:, j]
    return A, ev0.astype(np.float32), Um.astype(np.float32)


def _planted_mixtures_above_the_cap(n=256, n_flag=6, n_part=10, r=0.75):
    """Six eigenvector columns near the top (indices 216..221), each turned
    by 30 degrees toward its own decaying mixture of ten low columns
    (indices 0..59).  The repair span (MIX_MAX_BAD) holds fewer than the
    66 columns, and the low partners fill the first 48 column indices."""
    A = _spectrum_case(n, np.linspace(0.5, 4.0, n), 9)
    ev0, U0 = np.linalg.eigh(A.astype(np.float64))
    U = U0.copy()
    c, s = np.cos(np.pi / 6), np.sin(np.pi / 6)
    alpha = r ** np.arange(n_part)
    alpha /= np.linalg.norm(alpha)
    for g in range(n_flag):
        u = U0[:, n - 40 + g]
        w = U0[:, g * n_part:(g + 1) * n_part] @ alpha
        G = (np.eye(n) + (c - 1) * (np.outer(u, u) + np.outer(w, w))
             + s * (np.outer(w, u) - np.outer(u, w)))
        U = G @ U
    return A, ev0.astype(np.float32), U.astype(np.float32)


#: tests/test_eigh_dc.py's cases with n <= 300: (name, max_block, matrix)
def _cases():
    return {
        "two_level_gram": (96, _gram_case(300, 150, 11)),
        "wide_spectrum": (64, _spectrum_case(
            200, np.geomspace(1e-3, 1e3, 200), 12)),
        "small_passthrough": (64, _symmetric(40, 13)),
        "near_identity": (16, (3.5 * np.eye(64)).astype(np.float32)),
        "negative_and_positive": (48, _spectrum_case(
            150, np.linspace(-5.0, 5.0, 150), 14)),
    }


def _symmetric(n, seed):
    G = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return (G + G.T) / 2


_CHILD = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, sys.argv[3])
import jax.numpy as jnp
from pygemma_tpu import GwasConfig, pygemma
from pygemma_tpu.core.eigh_dc import _cholqr2, _residual_repair, eigh_dc

d = dict(np.load(sys.argv[1]))
out = {}
for name in [k[2:] for k in d if k.startswith("A_")]:
    ev, _ = eigh_dc(d["A_" + name], max_block=int(d["mb_" + name]))
    out["ev_" + name] = np.asarray(ev)
for name, max_bad in (("planted", 512), ("above_cap", %(max_bad)d)):
    ev, U = _residual_repair(jnp.asarray(d[name + "_A"]),
                             jnp.asarray(d[name + "_ev"]),
                             jnp.asarray(d[name + "_U"]), max_bad=max_bad)
    out[name + "_ev"] = np.asarray(ev)
    out[name + "_U"] = np.asarray(U)
Q = np.asarray(_cholqr2(jnp.asarray(d["cholqr_Y"])), np.float64)
out["cholqr_orth"] = np.abs(Q.T @ Q - np.eye(Q.shape[1])).max()
df = pygemma(d["y"], d["G"], d["W"], d["K"],
             config=GwasConfig(eigh_backend="dc", tests=%(tests)r))
for col in df.columns:
    out["tab_" + col] = df[col].to_numpy()
np.savez(sys.argv[2], **out)
"""


def _cholqr_case():
    """A well-conditioned (2048, 1536) block: condition number ~15."""
    return np.random.default_rng(21).standard_normal((2048, 1536)).astype(
        np.float32)


def _dc_flow_inputs():
    return oracle.simulate(n=DC_FLOW["n"], p=DC_FLOW["p"], c=3, seed=31)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eigh_dc")
    inp, outp = str(tmp / "in.npz"), str(tmp / "out.npz")
    d = {}
    for name, (mb, A) in _cases().items():
        d["A_" + name], d["mb_" + name] = A, np.int64(mb)
    for name, make in (("planted", _planted_mixture),
                       ("above_cap", _planted_mixtures_above_the_cap)):
        d[name + "_A"], d[name + "_ev"], d[name + "_U"] = make()
    d["y"], d["G"], d["W"], d["K"] = _dc_flow_inputs()
    d["cholqr_Y"] = _cholqr_case()
    np.savez(inp, **d)
    code = _CHILD % {"max_bad": MIX_MAX_BAD, "tests": DC_FLOW["tests"]}
    r = subprocess.run([sys.executable, "-c", code, inp, outp, ROOT],
                       capture_output=True, text=True, timeout=540)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(outp))


def _check(A, ev, U, ev_tol=2e-4, resid_tol=5e-4, orth_tol=5e-4):
    """tests/test_eigh_dc.py's ``_check``."""
    n = A.shape[0]
    ev, U = np.asarray(ev), np.asarray(U)
    A64 = np.asarray(A, np.float64)
    ev_ref = np.linalg.eigvalsh(A64)
    scale = np.abs(ev_ref).max()
    np.testing.assert_allclose(np.sort(ev), ev)
    np.testing.assert_allclose(ev, ev_ref, rtol=5e-4, atol=ev_tol * scale)
    np.testing.assert_allclose(U.T @ U, np.eye(n), atol=orth_tol)
    assert np.abs(A64 @ U - U * ev[None, :]).max() < resid_tol * scale


def _held_to_jax(ev, jax_ev, A, rtol=5e-4, atol=2e-4):
    scale = np.abs(np.linalg.eigvalsh(np.asarray(A, np.float64))).max()
    np.testing.assert_allclose(np.asarray(ev), jax_ev, rtol=rtol,
                               atol=atol * scale)


def _port(name):
    mb, A = _cases()[name]
    ev, U = tdc.eigh_dc(torch.as_tensor(A), max_block=mb)
    return A, ev.numpy(), U.numpy()


def test_eigh_dc_two_level_gram(jax_ref):
    """GRM-like PSD spectrum, forced 2+ levels of recursion."""
    A, ev, U = _port("two_level_gram")
    _check(A, ev, U)
    _held_to_jax(ev, jax_ref["ev_two_level_gram"], A)


def test_eigh_dc_wide_spectrum(jax_ref):
    """Eigenvalues spread across six decades: relative accuracy on the
    large end, absolute on the small end."""
    A, ev, U = _port("wide_spectrum")
    ev_ref = np.linalg.eigvalsh(A.astype(np.float64))
    for ref in (ev_ref, jax_ref["ev_wide_spectrum"]):
        np.testing.assert_allclose(ev, ref, rtol=5e-3,
                                   atol=2e-3 * np.abs(ev_ref).max())
    np.testing.assert_allclose(U.T @ U, np.eye(A.shape[0]), atol=5e-4)


def test_eigh_dc_small_passthrough(jax_ref):
    """n <= max_block goes straight to the built-in eigh."""
    A, ev, U = _port("small_passthrough")
    _check(A, ev, U, ev_tol=5e-5, resid_tol=2e-4)
    _held_to_jax(ev, jax_ref["ev_small_passthrough"], A, atol=5e-5)


def test_eigh_dc_near_identity(jax_ref):
    """A multiple of the identity cannot split by value: the forced half
    split must still give a valid eigendecomposition."""
    A, ev, U = _port("near_identity")
    np.testing.assert_allclose(ev, 3.5, rtol=1e-5)
    np.testing.assert_allclose(jax_ref["ev_near_identity"], 3.5, rtol=1e-5)
    np.testing.assert_allclose(U.T @ U, np.eye(64), atol=5e-4)


def test_eigh_dc_negative_and_positive(jax_ref):
    """Indefinite symmetric matrix (the splitter must handle signs)."""
    A, ev, U = _port("negative_and_positive")
    _check(A, ev, U)
    _held_to_jax(ev, jax_ref["ev_negative_and_positive"], A)


def test_eigh_dc_degenerate_cluster_spanning_median():
    """K = GG'/p + eps I with n > p has an (n - p)-fold eps eigenvalue
    that spans the split quantile; the gap-aware sigma must cut in the
    cluster/bulk gap (float64 NumPy reference only: the JAX module takes
    most of a minute here)."""
    n = 2500
    A = _gram_case(n, 1200, 17)
    ev, U = tdc.eigh_dc(torch.as_tensor(A), max_block=1024)
    ev_h, U_h = ev.numpy(), U.numpy()
    ev_ref = np.linalg.eigvalsh(A.astype(np.float64))
    scale = np.abs(ev_ref).max()
    np.testing.assert_allclose(ev_h, ev_ref, rtol=5e-3, atol=5e-4 * scale)
    np.testing.assert_allclose(U_h.T @ U_h, np.eye(n), atol=1e-3)
    resid = np.abs(A.astype(np.float64) @ U_h - U_h * ev_h[None, :]).max()
    assert resid < 5e-3 * scale


def _repaired(A, ev, U, max_bad=512):
    ev_r, U_r = tdc._residual_repair(torch.as_tensor(A), torch.as_tensor(ev),
                                     torch.as_tensor(U), max_bad=max_bad)
    return ev_r.numpy(), U_r.numpy()


def _max_resid(A, ev, U):
    return np.abs(A.astype(np.float64) @ U - U * ev[None, :]).max()


def test_residual_repair_fixes_planted_mixture(jax_ref):
    """The per-eigenpair certificate detects and repairs a planted rotation
    between two eigenvector columns."""
    A, evm, Um = _planted_mixture()
    s, _, _ = tdc._pair_residuals(torch.as_tensor(A), torch.as_tensor(Um),
                                  torch.as_tensor(evm))
    assert float(s.max()) > 0.1  # the defect is loud in the residual
    ev_r, U_r = _repaired(A, evm, Um)
    ev_ref = np.linalg.eigvalsh(A.astype(np.float64))
    for ev in (np.sort(ev_r), np.sort(jax_ref["planted_ev"])):
        np.testing.assert_allclose(ev, ev_ref, rtol=2e-5,
                                   atol=1e-5 * np.abs(ev_ref).max())
    np.testing.assert_allclose(U_r.T @ U_r, np.eye(A.shape[0]), atol=5e-4)
    assert _max_resid(A, ev_r, U_r) < 2e-4 * np.abs(ev_ref).max()


def test_repair_span_keeps_flagged_columns_above_the_cap(jax_ref):
    """Six flagged columns at indices above the repair span's cap, with 60
    coupling partners at lower indices.  The JAX module cut the sorted span
    at the cap by column index, dropping every flagged column, and its
    repair stalls; the port keeps the flagged columns and the partners that
    carry the most coupling mass, and repairs them."""
    A, evm, Um = _planted_mixtures_above_the_cap()
    scale = np.abs(np.linalg.eigvalsh(A.astype(np.float64))).max()
    tol = 2e-4 * scale
    jax_resid = _max_resid(A, jax_ref["above_cap_ev"], jax_ref["above_cap_U"])
    assert jax_resid > 10 * tol  # the case defeats the JAX module's span
    ev_r, U_r = _repaired(A, evm, Um, max_bad=MIX_MAX_BAD)
    np.testing.assert_allclose(np.sort(ev_r),
                               np.linalg.eigvalsh(A.astype(np.float64)),
                               rtol=2e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(U_r.T @ U_r, np.eye(A.shape[0]), atol=5e-4)
    assert _max_resid(A, ev_r, U_r) < tol


def test_cholqr2_reaches_float32_orthogonality(jax_ref):
    """CholeskyQR2 shifts only its first pass (which keeps a rank-deficient
    block's Cholesky from failing), so the second reaches float32
    orthogonality.  The JAX module shifts both passes by eps * trace(G),
    which leaves |Q'Q - I| near k * eps (its own call shows it here); at
    the 16,384 Gram's split (k ~ 9,750) that error reaches the eigenvalues
    and the certificate at ~1e-3 of max|ev|."""
    Q = tdc._cholqr2(torch.as_tensor(_cholqr_case())).double()
    err = float((Q.T @ Q - torch.eye(Q.shape[1], dtype=torch.float64))
                .abs().max())
    assert err < 1e-5, err
    assert jax_ref["cholqr_orth"] > 5e-5


def test_eigh_dc_gram_at_float32_accuracy():
    """A 2,048 x 2,048 Gram of standardized binomial codes (the large-GWAS
    kinship's Gram, cut to size) split at a 1,024 leaf: residuals and
    |U'U - I| within 2e-5 of max|ev|.  An eigenvalue sits within ~1e-4 of
    the root's sigma here: without the range find's spare columns the split
    mixes it (coupling 5e-3, residual 4e-3 after the repair), and with both
    CholeskyQR passes shifted |U'U - I| is 2.4e-4."""
    rng = np.random.default_rng(22)
    G = rng.binomial(2, 0.3, size=(2500, 2048)).astype(np.float32)
    G = (G - G.mean(0)) / G.std(0)
    A = (G.T @ G / 2048).astype(np.float32)
    ev, U = tdc.eigh_dc(torch.as_tensor(A), max_block=1024)
    _check(A, ev.numpy(), U.numpy(), ev_tol=2e-5, resid_tol=2e-5,
           orth_tol=2e-5)


def _coupling_run(A, max_block, theta, monkeypatch, capsys):
    """eigh_dc with the range finder patched: its first call returns NaN
    (attempt 0's coupling is NaN), its second the real basis with column 0
    turned by ``theta`` toward a direction outside its span.  Returns the
    result and the accepted coupling, read from the verbose lines."""
    real = tdc._orthonormal_range
    calls = []

    def patched(P, k, seed, refine=1, rows=tdc.WHOLE):
        Q = real(P, k, seed, refine, rows)
        calls.append(k)
        if len(calls) == 1:
            return torch.full_like(Q, float("nan"))
        g = torch.Generator().manual_seed(3)
        w = torch.randn(Q.shape[0], generator=g, dtype=Q.dtype)
        w -= Q @ (Q.T @ w)
        w /= torch.linalg.vector_norm(w)
        Q = Q.clone()
        Q[:, 0] = np.cos(theta) * Q[:, 0] + np.sin(theta) * w
        return Q

    monkeypatch.setattr(tdc, "_orthonormal_range", patched)
    monkeypatch.setenv("PYGEMMA_TPU_DC_VERBOSE", "1")
    capsys.readouterr()
    ev, U = tdc.eigh_dc(torch.as_tensor(A), max_block=max_block)
    log = capsys.readouterr().out
    assert len(calls) == 2, calls
    assert re.search(r"depth=0 retry range \(coupling nan\)", log), log
    m = re.search(r"depth=0 ranges\+pencil\+coupling ([0-9.e+-]+)", log)
    return ev.numpy(), U.numpy(), float(m.group(1))


def test_finite_range_retry_replaces_a_nan_attempt(monkeypatch, capsys):
    """Attempt 0 of the range find gives a NaN coupling, attempt 1 a finite
    one between the accept-at-once gate (8e-3) and the limit (2e-2).  The
    JAX module kept the NaN attempt as its best (a NaN never compares
    smaller) and raised; the port takes attempt 1 and returns a valid eigh.
    A first run at a small angle calibrates the angle that lands attempt
    1's coupling in that window."""
    vals = np.r_[np.linspace(1.0, 1.5, 48), np.linspace(2.5, 3.0, 48)]
    A = _spectrum_case(96, vals, 15)
    gate = float(np.abs(A).max())
    _, _, c0 = _coupling_run(A, 64, 2e-3, monkeypatch, capsys)
    assert c0 <= 8e-3 * gate  # accepted at once
    theta = 2e-3 * (1.3e-2 * gate / c0)
    ev, U, c1 = _coupling_run(A, 64, theta, monkeypatch, capsys)
    assert 8e-3 * gate < c1 <= 2e-2 * gate, (c1, gate)
    _check(A, ev, U)


def test_sign_iteration_runs_in_float64():
    """The sign iteration of a float32 matrix runs in float64: in float32
    its rounding leaks ~1e-3 between a split's blocks at n = 16,384, which
    chip_smoke's phase 12 holds on the card.  The result stays float32."""
    A = torch.as_tensor(_gram_case(64, 40, 3))
    assert tdc._shift_scale(A, 1.0, 0, 1.0).dtype == torch.float64
    ev, U = tdc.eigh_dc(A, max_block=16)
    assert ev.dtype == U.dtype == torch.float32


def test_eigh_dc_float64():
    """A float64 matrix: the Gaussians are drawn in float64 and the result
    is float64, accurate far beyond the float32 tolerances."""
    A = _gram_case(300, 150, 11).astype(np.float64)
    ev, U = tdc.eigh_dc(torch.as_tensor(A), max_block=96)
    assert ev.dtype == U.dtype == torch.float64
    _check(A, ev.numpy(), U.numpy(), ev_tol=1e-9, resid_tol=1e-8,
           orth_tol=1e-10)


def test_forced_dc_that_fails_raises(monkeypatch):
    """A forced "dc" whose split fails raises; it does not switch to
    another eigh."""
    def failing(P, k, seed, refine=1, rows=tdc.WHOLE):
        return torch.full((P.shape[0], k), float("nan"), dtype=P.dtype)

    monkeypatch.setattr(tdc, "_orthonormal_range", failing)
    monkeypatch.setattr(teigen, "eigh_dc",
                        functools.partial(tdc.eigh_dc, max_block=32))
    y, G, W, K = oracle.simulate(n=80, p=4, c=2, seed=3)
    with pytest.raises(RuntimeError, match="coupling nan"):
        pt.pygemma(y, G, W, K, config=pt.GwasConfig(eigh_backend="dc"),
                   device="cpu")


def _dlogp(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    return float(np.abs(np.log10(np.maximum(a[ok], 1e-300))
                        - np.log10(np.maximum(b[ok], 1e-300))).max())


def test_pygemma_dc_matches_jax(jax_ref):
    """The slice through the driver: ``eigh_backend="dc"`` on the port
    against the JAX package with the same config, float32 contract."""
    y, G, W, K = _dc_flow_inputs()
    tapi._EIGEN_DEV_CACHE.clear()
    got = pt.pygemma(y, G, W, K, device="cpu", config=pt.GwasConfig(
        eigh_backend="dc", tests=DC_FLOW["tests"]))
    for col in ("p_wald", "p_lrt", "p_score"):
        assert _dlogp(got[col], jax_ref["tab_" + col]) < 0.05, col
    ok = ~np.isnan(jax_ref["tab_beta"])
    np.testing.assert_allclose(got["beta"].to_numpy()[ok],
                               jax_ref["tab_beta"][ok], rtol=2e-3, atol=1e-5)


def test_split_basis_scan_matches_oracle():
    """eigh_dc with max_block 256 (two levels of splits at n = 600) and then
    the scan on the rotated inputs (``eigen=False``) against the float64
    oracle, |d log10 p| < 0.05."""
    y, G, W, K = oracle.simulate(n=600, p=800, c=3, seed=42)
    G = G[:, :16]  # the oracle is slow: 16 SNPs, a full-rank K
    ev, U = tdc.eigh_dc(torch.as_tensor(K.astype(np.float32)), max_block=256)
    ev, U = np.maximum(ev.numpy(), 0.0), U.numpy().astype(np.float64)
    df = pt.pygemma(U.T @ y, U.T @ G, U.T @ W, ev, eigen=False, device="cpu")
    ev64, U64 = np.linalg.eigh(K)
    ref = oracle.assoc_scan(np.maximum(ev64, 0.0), U64.T @ W, U64.T @ y,
                            U64.T @ G)
    assert _dlogp(df["p_wald"], ref["p_wald"]) < 0.05


def test_lowrank_top_basis_dc_matches_device(monkeypatch):
    """``lowrank_top_basis(lrk, "dc")`` (split at a 32-wide leaf) against
    ``"device"``: the same top eigenvalues and top-space projector, and the
    same implicit scan."""
    rng = np.random.default_rng(8)
    n, pk = 200, 90
    G = rng.binomial(2, 0.3, size=(n, pk)).astype(np.float32)
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-6)
    lrk = tlow.LowRankKinship(G, eps=1e-3)
    monkeypatch.setattr(teigen, "eigh_dc",
                        functools.partial(tdc.eigh_dc, max_block=32))
    dc = tlow.lowrank_top_basis(lrk, "dc", device="cpu")
    dev = tlow.lowrank_top_basis(lrk, "device", device="cpu")
    np.testing.assert_allclose(dc.ev_top.numpy(), dev.ev_top.numpy(),
                               rtol=5e-4, atol=2e-4 * float(dev.ev_top.max()))
    P_dc = dc.U_top.double() @ dc.U_top.double().T
    P_dev = dev.U_top.double() @ dev.U_top.double().T
    np.testing.assert_allclose(P_dc.numpy(), P_dev.numpy(), atol=2e-4)
    X = rng.binomial(2, 0.4, size=(n, 24)).astype(np.float32)
    y = (0.3 * G[:, :3].sum(1) + rng.standard_normal(n)).astype(np.float32)
    tables = []
    for backend in ("device", "dc"):
        # the device cache keys the basis by kinship, not by backend
        tapi._EIGEN_DEV_CACHE.clear()
        tables.append(pt.pygemma(y, X, None, lrk, device="cpu",
                                 config=pt.GwasConfig(eigh_backend=backend)))
    tapi._EIGEN_DEV_CACHE.clear()
    assert _dlogp(tables[1]["p_wald"], tables[0]["p_wald"]) < 0.05
    ok = ~np.isnan(tables[0]["beta"].to_numpy())
    np.testing.assert_allclose(tables[1]["beta"].to_numpy()[ok],
                               tables[0]["beta"].to_numpy()[ok],
                               rtol=2e-3, atol=1e-5)
