"""The port's low-rank kinship and implicit-complement scan against the JAX
package and the dense float64 eigh.

The basis is held to a dense float64 eigh; the complement-corrected Grams to
the explicit full-basis Grams (float64, 1e-9) and to the JAX package's
corrected Grams; the kernel's plain version with the complement to the JAX
package's Pallas kernel in interpret mode; ``assoc_block`` and the driver on
the implicit path to the JAX package's, with tests/test_lowrank.py's
tolerances.  The complement basis of the explicit path differs from JAX's
(another random draw); the statistics do not.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pygemma_tpu as pj
import pygemma_tpu_torch as pt
from pygemma_tpu import api as japi
from pygemma_tpu.core import assoc as jassoc
from pygemma_tpu.core import grams as jgrams
from pygemma_tpu.core import lowrank as jlow
from pygemma_tpu.io import packed as jpacked
from pygemma_tpu_torch import api as tapi
from pygemma_tpu_torch import convert
from pygemma_tpu_torch.core import assoc as tassoc
from pygemma_tpu_torch.core import grams as tgrams
from pygemma_tpu_torch.core import lowrank as tlow
from pygemma_tpu_torch.core.eigen import auto_eigendecompose
from pygemma_tpu_torch.io import packed as tpacked
from pygemma_tpu_torch.utils import profiling

torch.set_num_threads(2)

CPU = "cpu"


def _case(rng, n=140, pk=40, c=2, p=24, dtype=np.float32):
    """tests/test_implicit.py's case: standardized binomial G and X."""
    G = rng.binomial(2, 0.3, size=(n, pk)).astype(dtype)
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-6)
    W = np.c_[np.ones(n), rng.standard_normal((n, c - 1))].astype(dtype)
    y = (0.4 * G[:, :4].sum(1) + rng.standard_normal(n)).astype(dtype)
    X = rng.binomial(2, 0.4, size=(n, p)).astype(dtype)
    X = (X - X.mean(0)) / np.maximum(X.std(0), 1e-6)
    return G, W, y, X


def _dense64(G, eps=1e-3):
    Gc = np.asarray(G, np.float64)
    Gc = Gc - Gc.mean(0)
    return Gc @ Gc.T / G.shape[1] + eps * np.eye(G.shape[0])


def _assert_basis(ev, U, K64, tol):
    ev, U = ev.numpy(), U.numpy()
    n = K64.shape[0]
    assert ev.shape == (n,) and U.shape == (n, n)
    np.testing.assert_array_equal(np.sort(ev), ev)  # ascending
    np.testing.assert_allclose(ev, np.linalg.eigvalsh(K64), rtol=2e-4,
                               atol=max(tol, 2e-5))
    np.testing.assert_allclose(U.T.astype(np.float64) @ U, np.eye(n),
                               atol=5e-5)
    assert np.abs(K64 @ U - U * ev[None, :]).max() < tol


def test_lowrank_matches_dense_eigh(rng):
    G, _, _, _ = _case(rng, n=150, pk=60)
    ev, U = tlow.lowrank_eigendecompose(tlow.LowRankKinship(G, eps=1e-3),
                                        device=CPU)
    _assert_basis(ev, U, _dense64(G), 5e-5)


def test_lowrank_rank_deficient_gram(rng):
    """Duplicated SNP columns make the Gram rank-deficient: the null
    directions fold into the eps eigenspace and the basis stays
    complete."""
    G, _, _, _ = _case(rng, n=90, pk=40)
    G[:, 1] = G[:, 2] = G[:, 0]
    lrk = tlow.LowRankKinship(G, eps=1e-3)
    ev, U = tlow.lowrank_eigendecompose(lrk, device=CPU)
    _assert_basis(ev, U, _dense64(G), 1e-4)
    basis = tlow.lowrank_top_basis(lrk, device=CPU)
    assert int((basis.U_top.abs().sum(0) == 0).sum()) == 2  # zeroed columns
    np.testing.assert_array_equal(basis.ev_top.numpy()[:2], np.float32(1e-3))


@pytest.mark.parametrize("source", ["packed", "int8"])
def test_lowrank_from_streamed_source(rng, source):
    """A LowRankKinship over 2-bit or int8 codes streams them (block 16)."""
    codes = rng.integers(0, 3, size=(100, 36)).astype(np.uint8)
    if source == "packed":
        Q = tpacked.PackedMatrix.from_codes(codes)
    else:
        from pygemma_tpu_torch.io.quantized import QuantizedMatrix
        Q = QuantizedMatrix.from_dosages(codes.astype(np.int8))
    lrk = tlow.LowRankKinship(Q, eps=1e-3)
    ev, _ = tlow.lowrank_eigendecompose(lrk, block=16, device=CPU)
    np.testing.assert_allclose(ev.numpy(),
                               np.linalg.eigvalsh(_dense64(Q[:, :])),
                               rtol=2e-4, atol=2e-5)
    top = tlow.lowrank_top_basis(lrk, block=16, device=CPU)
    ref = jlow.lowrank_top_basis(jlow.LowRankKinship(Q[:, :], eps=1e-3))
    np.testing.assert_allclose(top.ev_top.numpy(), np.asarray(ref.ev_top),
                               rtol=2e-4, atol=2e-5)


def test_top_basis_respool_matches_resident(rng):
    G, _, _, _ = _case(rng, n=120, pk=32)
    lrk = tlow.LowRankKinship(G, eps=1e-3)
    profiling.enable()
    try:
        a = tlow.lowrank_top_basis(lrk, device=CPU)
        stages = [s.name for s in profiling.collect()
                  if s.name.startswith("lowrank.")]
    finally:
        profiling.disable()
    b = tlow.lowrank_top_basis(lrk, device=CPU, respool_bytes=0)
    assert stages == ["lowrank.stream_gram", "lowrank.gram_eigh",
                      "lowrank.top_basis"]
    assert torch.equal(a.ev_top, b.ev_top) and torch.equal(a.U_top, b.U_top)


def test_lowrank_requires_pk_lt_n(rng):
    with pytest.raises(ValueError, match="p_k < n"):
        tlow.LowRankKinship(rng.standard_normal((10, 12)).astype(np.float32))


def test_eigendecompose_takes_a_device_tensor(rng):
    """The p_k x p_k Gram is decomposed where it lies, without a host
    round trip, and agrees with the host-array path."""
    A = rng.standard_normal((30, 30))
    A = A @ A.T
    ev_t, U_t = auto_eigendecompose(torch.as_tensor(A), dtype=np.float64,
                                    device=CPU)
    ev_h, U_h = auto_eigendecompose(A, dtype=np.float64, device=CPU)
    assert torch.equal(ev_t, ev_h) and torch.equal(U_t, U_h)
    ev32, _ = auto_eigendecompose(torch.as_tensor(A), backend="host",
                                  dtype=np.float32, device=CPU)
    assert ev32.dtype == torch.float32
    np.testing.assert_allclose(ev32.numpy(), ev_h.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ev_h.max()))


def _implicit_inputs(G, eps=1e-3):
    """Exact float64 top space of K = GG'/p_k + eps I (test-side)."""
    Gc = np.asarray(G, np.float64)
    Gc = Gc - Gc.mean(0)
    scale = 1.0 / G.shape[1]
    a, V = np.linalg.eigh(scale * (Gc.T @ Gc))
    a = np.maximum(a, 0)
    U_top = (Gc @ V) * np.where(a > 1e-9,
                                np.sqrt(scale / np.maximum(a, 1e-9)), 0.0)
    return np.where(a > 1e-9, a, 0.0) + eps, U_top


def _comp_args(G, W, y, X, dtype):
    """Full-basis and top-space Gram inputs plus the residuals, as numpy."""
    n, pk = G.shape
    ev_top, U_top = _implicit_inputs(G)
    ev_full, U_full = np.linalg.eigh(_dense64(G))
    ev_full = np.maximum(ev_full, 0)
    sh_raw = np.c_[W, y].astype(np.float64)
    X64 = X.astype(np.float64)
    sh_f, v_f = U_full.T @ sh_raw, U_full.T @ X64
    sh_c, v_c = U_top.T @ sh_raw, U_top.T @ X64
    resid = (sh_raw.T @ sh_raw - sh_c.T @ sh_c,
             X64.T @ sh_raw - v_c.T @ sh_c,
             (X64 ** 2).sum(0) - (v_c ** 2).sum(0))
    cast = lambda *a: [np.asarray(x, dtype) for x in a]  # noqa: E731
    return (cast(ev_full, sh_f, v_f), cast(ev_top, sh_c, v_c),
            cast(*resid), n - pk)


def _t(a):
    return torch.as_tensor(np.array(a))


def _torch_args(ev, sh, v):
    sh_t = _t(sh)
    v_t = _t(v)
    return (_t(ev), sh_t, tgrams.pair_products(sh_t), v_t, v_t * v_t)


def _jax_args(ev, sh, v):
    sh_j = jnp.asarray(sh)
    v_j = jnp.asarray(v)
    return (jnp.asarray(ev), sh_j, jgrams.pair_products(sh_j), v_j, v_j * v_j)


LAYOUTS = ["scalar", "multi", "per_snp", "slots"]


def _torch_build(layout, lam, args, ks, comp):
    """The port's builds of each layout: the packed builders, assembled and
    corrected for the complement per lambda layout (a (B, R) slot layout
    slot by slot)."""
    if layout == "slots":
        parts = [_torch_build("per_snp", lam[:, r], args, ks, comp)
                 for r in range(lam.shape[1])]
        return (tuple(torch.stack([g[i] for g, _ in parts], dim=1)
                      for i in range(len(ks))),
                tgrams.GramSums(*(torch.stack([sm[i] for _, sm in parts],
                                              dim=1) for i in range(3))))
    build = {"scalar": tgrams.grams_shared_lambda_packed,
             "multi": tgrams.grams_shared_multi_packed,
             "per_snp": tgrams.grams_per_snp_lambda_packed}[layout]
    packed = build(lam, *args, ks, want_logh=True)
    grams = tgrams.assemble(packed)
    if comp is None:
        return grams, packed.sums
    return tgrams._complement_correct(grams, packed.sums, ks, comp, lam,
                                      layout, True)


def _build(mod, layout, lam, args, comp):
    ks = (1, 2) if layout == "multi" else (1, 2, 3)
    if mod is tgrams:
        return _torch_build(layout, lam, args, ks, comp)
    if layout == "scalar":
        return mod.grams_shared_lambda(lam, *args, ks, want_logh=True,
                                       comp=comp)
    if layout == "multi":
        return mod.grams_shared_multi(lam, *args, ks, want_logh=True,
                                      comp=comp)
    if layout == "per_snp":
        return mod.grams_per_snp_lambda(lam, *args, ks, want_logh=True,
                                        comp=comp)
    return mod.grams_per_snp_lambda_slots(lam, *args, ks, want_logh=True,
                                          comp=comp)


def _lams(rng, layout, B):
    if layout == "scalar":
        return np.float64(3.7)
    if layout == "multi":
        return np.array([1e-5, 1e-2, 1.0, 37.0, 1e5])
    return rng.uniform(1e-3, 1e3, size=B if layout == "per_snp" else (B, 3))


def _check_pairs(got, ref, tol):
    (ga, sa), (gb, sb) = got, ref
    for A, Bm in zip(ga, gb):
        np.testing.assert_allclose(np.asarray(A), np.asarray(Bm), rtol=tol,
                                   atol=tol)
    for fa, fb in zip(sa, sb):
        np.testing.assert_allclose(np.asarray(fa), np.asarray(fb), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_grams_complement_exact_float64(rng, layout):
    """Complement-corrected top-space Grams equal the explicit full-basis
    Grams and the JAX package's corrected Grams, float64, 1e-9."""
    G, W, y, X = _case(rng, dtype=np.float64)
    full, top, (R_S, R_vS, R_vv), n_comp = _comp_args(G, W, y, X, np.float64)
    lam = _lams(rng, layout, X.shape[1])
    comp = tgrams.GramComplement(torch.tensor(1e-3, dtype=torch.float64),
                                 n_comp, _t(R_S), _t(R_vS), _t(R_vv))
    got = _build(tgrams, layout, _t(lam), _torch_args(*top), comp)
    _check_pairs(got, _build(tgrams, layout, _t(lam), _torch_args(*full),
                             None), 1e-9)
    if layout != "slots":  # the JAX package's slots builder is the same loop
        jcomp = jgrams.GramComplement(jnp.float64(1e-3), n_comp,
                                      jnp.asarray(R_S), jnp.asarray(R_vS),
                                      jnp.asarray(R_vv))
        ref = _build(jgrams, layout, jnp.asarray(lam), _jax_args(*top), jcomp)
        _check_pairs(got, ref, 1e-9)


@pytest.mark.parametrize("R", [1, 2])
def test_kernel_plain_version_with_complement_matches_jax(rng, R):
    """The fused builder (the kernel's plain version on CPU tensors) with
    the complement folded in, against the JAX package's Pallas kernel in
    interpret mode: 2e-4, as tests/test_implicit.py."""
    from jax.experimental.pallas import tpu as pltpu

    G, W, y, X = _case(rng, n=96, pk=24, p=8)
    _, (ev, sh, v), (R_S, R_vS, R_vv), n_comp = _comp_args(G, W, y, X,
                                                           np.float32)
    lam = rng.uniform(0.1, 10.0, size=8 if R == 1 else (8, R)).astype(
        np.float32)
    comp = tgrams.GramComplement(torch.tensor(1e-3), n_comp, _t(R_S),
                                 _t(R_vS), _t(R_vv))
    args = _torch_args(ev, sh, v)[:4]
    packed = tgrams.grams_per_snp_lambda_fused_packed(_t(lam), *args, (1, 2),
                                                      want_logh=True)
    grams, sums = tgrams.assemble(packed), packed.sums
    if R == 1:
        got = tgrams._complement_correct(grams, sums, (1, 2), comp, _t(lam),
                                         "per_snp", True)
    else:  # slot by slot
        parts = [tgrams._complement_correct(
            tuple(A[:, r] for A in grams),
            tgrams.GramSums(*(x[:, r] for x in sums)), (1, 2), comp,
            _t(lam[:, r]), "per_snp", True) for r in range(R)]
        got = (tuple(torch.stack([g[i] for g, _ in parts], dim=1)
                     for i in range(2)),
               tgrams.GramSums(*(torch.stack([sm[i] for _, sm in parts],
                                             dim=1) for i in range(3))))
    jcomp = jgrams.GramComplement(jnp.float32(1e-3), n_comp,
                                  jnp.asarray(R_S), jnp.asarray(R_vS),
                                  jnp.asarray(R_vv))
    with pltpu.force_tpu_interpret_mode():
        ref = jgrams.grams_per_snp_lambda_fused(
            jnp.asarray(lam), *_jax_args(ev, sh, v)[:4], (1, 2),
            want_logh=True, comp=jcomp)
    _check_pairs(got, ref, 2e-4)


def _jax_basis(G):
    basis = jlow.lowrank_top_basis(jlow.LowRankKinship(G, eps=1e-3))
    return np.asarray(basis.ev_top), np.asarray(basis.U_top)


def _close_stats(got, ref, cols=("p_wald",), dlogp=0.05, rows=None,
                 lam=True):
    """tests/test_lowrank.py's tolerances: |d log10 p| < 0.05, beta rtol
    2e-3 atol 1e-5, lambda rtol 5e-3 (unless ``lam`` is False); NaN rows
    equal.  ``rows`` (a boolean mask) limits the comparison."""
    def col(t, k):
        a = np.asarray(t[k], np.float64)
        return a if rows is None else a[rows]

    for k in ("beta", "lambda") + tuple(cols):
        np.testing.assert_array_equal(np.isnan(col(got, k)),
                                      np.isnan(col(ref, k)), err_msg=k)
    ok = ~np.isnan(col(ref, "beta"))
    np.testing.assert_allclose(col(got, "beta")[ok], col(ref, "beta")[ok],
                               rtol=2e-3, atol=1e-5)
    if lam:
        np.testing.assert_allclose(col(got, "lambda")[ok],
                                   col(ref, "lambda")[ok], rtol=5e-3)
    for k in cols:
        a = np.maximum(col(got, k)[ok], 1e-300)
        b = np.maximum(col(ref, k)[ok], 1e-300)
        d = np.abs(np.log10(a) - np.log10(b)).max()
        assert d < dlogp, (k, d)


def test_implicit_assoc_block_matches_jax(rng):
    """assoc_block and fit_null on the implicit path, same top-space inputs
    (the JAX package's basis), Wald + LRT + score."""
    G, W, y, X = _case(rng)
    n = G.shape[0]
    ev_top, U_top = _jax_basis(G)
    sh_raw = np.c_[W, y].astype(np.float32)
    raw = (sh_raw.T @ sh_raw, X.T @ sh_raw, (X * X).sum(0))
    W_c, y_c, C_x = U_top.T @ W, U_top.T @ y, U_top.T @ X
    cfg_j = pj.GwasConfig(tests=("wald", "lrt", "score"))
    jctx = jassoc.ImplicitCtx(jnp.float32(1e-3), n,
                              *(jnp.asarray(a) for a in raw))
    jnull = jassoc.fit_null(jnp.asarray(ev_top), jnp.asarray(W_c),
                            jnp.asarray(y_c), cfg_j, implicit=jctx)
    jres = jassoc.assoc_block(jnp.asarray(ev_top), jnp.asarray(W_c),
                              jnp.asarray(y_c), jnp.asarray(C_x), cfg_j,
                              null=jnull, implicit=jctx)
    cfg_t = pt.GwasConfig(tests=("wald", "lrt", "score"))
    tctx = tassoc.ImplicitCtx(torch.tensor(1e-3), n, *(_t(a) for a in raw))
    tnull = tassoc.fit_null(_t(ev_top), _t(W_c), _t(y_c), cfg_t,
                            implicit=tctx)
    tres = tassoc.assoc_block(_t(ev_top), _t(W_c), _t(y_c), _t(C_x), cfg_t,
                              null=tnull, implicit=tctx)
    np.testing.assert_allclose(float(tnull.lambda_reml),
                               float(jnull.lambda_reml), rtol=5e-3)
    got = {"beta": tres.beta, "lambda": tres.lam, "p_wald": tres.p_wald,
           "p_lrt": tres.p_lrt, "p_score": tres.p_score}
    ref = {"beta": jres.beta, "lambda": jres.lam, "p_wald": jres.p_wald,
           "p_lrt": jres.p_lrt, "p_score": jres.p_score}
    _close_stats({k: v.numpy() for k, v in got.items()},
                 {k: np.asarray(v) for k, v in ref.items()},
                 cols=("p_wald", "p_lrt", "p_score"))


FLOWS = {
    "wald": {},
    "lrt_score": {"tests": ("wald", "lrt", "score")},
    "de": {"de": True},
    "grid": {"grid": True},
}


@pytest.fixture(scope="module")
def driver_case():
    rng = np.random.default_rng(21)
    G, W, y, X = _case(rng, p=40)
    X[:, 5] = 1.0  # constant SNP, collinear with the intercept
    return G, W, y, X


@pytest.mark.parametrize("flow", list(FLOWS))
def test_implicit_driver_matches_jax(driver_case, flow):
    G, W, y, X = driver_case
    kw = FLOWS[flow]
    ref = pj.pygemma(y, X, W, jlow.LowRankKinship(G, eps=1e-3),
                     config=pj.GwasConfig(snp_block=16), **kw)
    got = pt.pygemma(y, X, W, tlow.LowRankKinship(G, eps=1e-3),
                     config=pt.GwasConfig(snp_block=16), device=CPU, **kw)
    assert list(got.columns) == list(ref.columns)
    cols = [c for c in got.columns if c.startswith("p_")]
    if flow == "grid":  # the same decade grid, the same argmax
        np.testing.assert_array_equal(got["lambda"], ref["lambda"])
    if flow == "de":
        # the constant SNP is a degenerate outcome, and an outcome's lambda
        # near the 1e-5 end of the grid is ill-determined in float32: hold
        # beta and p, as tests/test_implicit.py holds DE mode
        rows = np.arange(len(got)) != 5
        _close_stats(got, ref, cols=tuple(cols), rows=rows, lam=False)
    else:
        _close_stats(got, ref, cols=tuple(cols))
        assert got.iloc[5].isna().all()  # the constant SNP: a full NaN row


def test_explicit_lowrank_path_matches_implicit(driver_case):
    """lowrank_implicit=False decomposes K fully (a complement QR from the
    port's own random draw) and gives the implicit path's statistics."""
    G, W, y, X = driver_case
    cfg = pt.GwasConfig(snp_block=16, tests=("wald", "lrt", "score"))
    lrk = tlow.LowRankKinship(G, eps=1e-3)
    imp = pt.pygemma(y, X, W, lrk, config=cfg, device=CPU)
    exp = pt.pygemma(y, X, W, lrk, config=cfg.replace(lowrank_implicit=False),
                     device=CPU)
    _close_stats(imp, exp, cols=("p_wald", "p_lrt", "p_score"), dlogp=0.1)
    assert exp.iloc[5].isna().all() and imp.iloc[5].isna().all()


def test_bench_shaped_packed_cohort_matches_jax(rng):
    """The large-GWAS path in miniature: a 2-bit cohort, K the GRM of its
    first SNPs as a LowRankKinship over the packed columns, both packages;
    and the port's packed scan equals its own float32 scan."""
    n, p, pk = 160, 48, 32
    codes = rng.binomial(2, 0.3, size=(n, p)).astype(np.uint8)
    J = jpacked.PackedMatrix.from_codes(codes)
    T = tpacked.PackedMatrix.from_codes(codes)
    W = np.c_[np.ones(n), rng.standard_normal((n, 2))].astype(np.float32)
    y = (2.0 * T[:, :8].mean(1) + rng.standard_normal(n)).astype(np.float32)
    ref = pj.pygemma(y, J, W, jlow.LowRankKinship(J.cols(0, pk), eps=1e-3),
                     config=pj.GwasConfig(snp_block=16))
    lrk = tlow.LowRankKinship(T.cols(0, pk), eps=1e-3)
    got = pt.pygemma(y, T, W, lrk, config=pt.GwasConfig(snp_block=16),
                     device=CPU)
    _close_stats(got, ref)
    dense = pt.pygemma(y, T[:, :], W, lrk, config=pt.GwasConfig(snp_block=16),
                       device=CPU)
    np.testing.assert_array_equal(got.to_numpy(), dense.to_numpy())


def test_implicit_checkpoint_resume_and_shared_eigen_file(driver_case,
                                                          tmp_path,
                                                          monkeypatch):
    """run_dir on the implicit path: the resumed scan reads its blocks back
    bit for bit; the JAX package's "|implicit" eigen file is found by the
    port (same fingerprint), so no basis is computed."""
    G, W, y, X = driver_case
    cfg = pt.GwasConfig(snp_block=16)
    lrk = tlow.LowRankKinship(G, eps=1e-3)
    run = str(tmp_path / "port")
    first = pt.pygemma(y, X, W, lrk, config=cfg, run_dir=run, device=CPU)
    tapi._EIGEN_DEV_CACHE.clear()
    again = pt.pygemma(y, X, W, lrk, config=cfg, run_dir=run, device=CPU)
    np.testing.assert_array_equal(first.to_numpy(), again.to_numpy())

    ref = pj.pygemma(y, X, W, jlow.LowRankKinship(G, eps=1e-3),
                     config=pj.GwasConfig(snp_block=16),
                     run_dir=str(tmp_path / "jax"))
    (tmp_path / "shared").mkdir()
    shutil.copy(tmp_path / "jax" / "eigen.npz", tmp_path / "shared")

    def no_basis(*a, **k):
        raise AssertionError("the cached top basis was not reused")

    monkeypatch.setattr(tapi, "lowrank_top_basis", no_basis)
    tapi._EIGEN_DEV_CACHE.clear()
    got = pt.pygemma(y, X, W, lrk, config=cfg,
                     run_dir=str(tmp_path / "shared"), device=CPU)
    _close_stats(got, ref)


@pytest.mark.parametrize("source", ["ndarray", "packed"])
def test_kinship_fingerprint_matches_jax(rng, source):
    G, _, _, _ = _case(rng, n=100, pk=30)
    if source == "packed":
        codes = rng.integers(0, 3, size=(100, 30)).astype(np.uint8)
        Gt = tpacked.PackedMatrix.from_codes(codes)
        Gj = jpacked.PackedMatrix.from_codes(codes)
    else:
        Gt = Gj = G
    a = tapi._kinship_fingerprint(tlow.LowRankKinship(Gt, eps=1e-3))
    b = japi._kinship_fingerprint(jlow.LowRankKinship(Gj, eps=1e-3))
    assert a == b
    assert a != tapi._kinship_fingerprint(tlow.LowRankKinship(Gt, eps=1e-2))


def test_lowrank_input_checks(driver_case, monkeypatch):
    G, W, y, X = driver_case
    lrk = tlow.LowRankKinship(G, eps=1e-3)
    with pytest.raises(ValueError, match="dense K"):
        pt.pygemma(y, X, W, lrk, Z=np.eye(G.shape[0]), device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tlow.lowrank_top_basis, tlow.lowrank_eigendecompose):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(lrk)  # the card by default, and no fallback to the CPU


def test_convert_lowrank_and_basis_from_jax(driver_case):
    """A JAX LowRankKinship (ndarray or packed source) and a JAX
    ImplicitBasis convert to the port's; the converted basis drives the
    port's implicit scan to the same table as the port's own basis."""
    G, W, y, X = driver_case
    jl = jlow.LowRankKinship(G, eps=1e-3, scale=0.5, center=False)
    tl = convert.from_jax(jl)
    assert isinstance(tl, tlow.LowRankKinship) and tl.G is G
    assert (tl.scale, tl.eps, tl.center, tl.n, tl.pk) == (0.5, 1e-3, False,
                                                          jl.n, jl.pk)
    codes = np.random.default_rng(2).integers(0, 3, size=(140, 20)).astype(
        np.uint8)
    jp = jlow.LowRankKinship(jpacked.PackedMatrix.from_codes(codes), eps=1e-3)
    tp = convert.from_jax(jp)
    assert isinstance(tp.G, tpacked.PackedMatrix)
    assert tapi._kinship_fingerprint(tp) == japi._kinship_fingerprint(jp)

    jb = jlow.lowrank_top_basis(jlow.LowRankKinship(G, eps=1e-3))
    tb = convert.from_jax(jb, device=CPU)
    assert isinstance(tb, tlow.ImplicitBasis) and tb.U_top.shape == (140, 40)
    lrk = tlow.LowRankKinship(G, eps=1e-3)
    cfg = pt.GwasConfig(snp_block=16)
    own = pt.pygemma(y, X, W, lrk, config=cfg, device=CPU)
    key = (f"{tapi._kinship_fingerprint(lrk)}|float32|implicit", CPU)
    tapi._EIGEN_DEV_CACHE.clear()
    tapi._EIGEN_DEV_CACHE[key] = (tb.ev_top, tb.U_top)
    via_jax = pt.pygemma(y, X, W, lrk, config=cfg, device=CPU)
    tapi._EIGEN_DEV_CACHE.clear()
    _close_stats(via_jax, own)
    with pytest.raises(ValueError, match="expected"):
        convert.implicit_basis_from_numpy(np.ones(3), np.ones((5, 4)), 1e-3,
                                          5, device=CPU)
