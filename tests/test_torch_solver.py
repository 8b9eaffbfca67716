"""Port lambda solver (pygemma_tpu_torch.core.solver) against JAX solve_lambda."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oracle
from pygemma_tpu.config import GwasConfig as JCfg
from pygemma_tpu.core import solver as js
from pygemma_tpu.core.grams import pair_products as j_pairs
from pygemma_tpu_torch.config import GwasConfig as TCfg
from pygemma_tpu_torch.core import solver as ts
from pygemma_tpu_torch.core.grams import pair_products as t_pairs

torch.set_num_threads(2)

TOL = {"float64": 1e-8, "float32": 3e-3}


def _gwas_block():
    y, G, W, K = oracle.simulate(n=160, p=16, c=2, seed=31)
    ev, U = np.linalg.eigh(K)
    X = U.T @ G
    X[:, 5] = 0.0  # constant SNP after centering: no root, degenerate Gram
    X[:, 9] = np.nan  # NaN lane
    return np.maximum(ev, 0.0), np.c_[U.T @ W, U.T @ y], X, True, W.shape[1] + 1


def _multiroot_block():
    """Lanes with 2+ decade sign changes (test_solver_e2e's fixture): with
    B = 12 lanes and >= 24 roots the compaction walks several batches."""
    rng = np.random.default_rng(147)
    n = int(rng.integers(8, 30))
    ev = 10.0 ** rng.uniform(-5, 5, size=n)
    W = np.ones((n, 1))
    Y = np.random.default_rng(0).normal(size=(n, 512))
    decades = [10.0 ** e for e in range(-5, 6)]
    keep = []
    for t in range(Y.shape[1]):
        s = np.sign([oracle.d1_restricted(l, ev, Y[:, t], W) for l in decades])
        if int(np.sum(s[:-1] * s[1:] < 0)) >= 2:
            keep.append(t)
        if len(keep) == 12:
            break
    return ev, W, Y[:, keep], False, 1


@pytest.fixture(scope="module", params=["gwas", "multiroot"])
def block(request):
    return _gwas_block() if request.param == "gwas" else _multiroot_block()


def _solve_both(block, dtype, restricted, **cfg):
    ev, shared, v, permute, q = block
    n = len(ev)
    jcfg = JCfg(dtype=dtype, **cfg)

    @jax.jit  # one compile instead of op-by-op dispatch of the whole solver
    def jax_solve(ev_, sh_, v_):
        prob = js.LambdaProblem(ev_, sh_, j_pairs(sh_), v_, v_ * v_, n, q,
                                permute, restricted)
        return js.solve_lambda(prob, jcfg)

    tv = torch.as_tensor(v.astype(dtype))
    tsh = torch.as_tensor(shared.astype(dtype))
    tp = ts.LambdaProblem(torch.as_tensor(ev.astype(dtype)), tsh, t_pairs(tsh),
                          tv, tv * tv, n, q, permute, restricted)
    lj, llj = jax_solve(*(jnp.asarray(a.astype(dtype)) for a in (ev, shared, v)))
    lt, llt = ts.solve_lambda(tp, TCfg(dtype=dtype, **cfg))
    return (np.asarray(lj), np.asarray(llj)), (lt.numpy(), llt.numpy()), tp


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["reml", "ml", "grid"])
def test_lambda_and_loglik_match_jax(block, dtype, mode):
    restricted = mode != "ml"
    kw = {"grid": True} if mode == "grid" else {}
    (lj, llj), (lt, llt), _ = _solve_both(block, dtype, restricted, **kw)
    rtol = TOL[dtype]
    np.testing.assert_allclose(lt, lj, rtol=rtol)
    # ell* carries n*log(.) terms: compare relative to its own scale
    np.testing.assert_allclose(llt, llj, rtol=rtol,
                               atol=rtol * np.nanmax(np.abs(llj)))
    # NaN / degenerate lanes agree lane for lane
    np.testing.assert_array_equal(np.isnan(llt), np.isnan(llj))


def test_fused_route_on_cpu_is_the_plain_version():
    """fused=True on CPU tensors runs the kernel's plain version: the same
    lambdas, bit for bit, and no kernel launch."""
    from pygemma_tpu_torch.ops.gram_kernel import fused_grams

    ev, shared, v, permute, q = _gwas_block()
    tsh = torch.as_tensor(shared.astype(np.float32))
    tv = torch.as_tensor(v.astype(np.float32))
    args = (torch.as_tensor(ev.astype(np.float32)), tsh, t_pairs(tsh), tv,
            tv * tv, len(ev), q, permute, True)
    before = fused_grams.launches
    a = ts.solve_lambda(ts.LambdaProblem(*args, fused=True), TCfg())
    b = ts.solve_lambda(ts.LambdaProblem(*args, fused=False), TCfg())
    assert fused_grams.launches == before
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_host_syncs_are_counted():
    ev, shared, v, permute, q = _gwas_block()
    tsh = torch.as_tensor(shared)
    tv = torch.as_tensor(v)
    prob = ts.LambdaProblem(torch.as_tensor(ev), tsh, t_pairs(tsh), tv,
                            tv * tv, len(ev), q, permute, True)
    cfg = TCfg(dtype="float64")
    before = ts.host_value.count
    ts.solve_lambda(prob, cfg)
    # one batch count per solve + at most one early-exit test per Newton
    # iteration of each batch
    used = ts.host_value.count - before
    assert 1 <= used <= 1 + cfg.newton_iters * (cfg.n_grid - 1)


def test_nan_sign_product_matches_jnp_sign():
    """Newton's three-way sign test: a NaN lane must NOT count as a bad
    sign (jnp.sign(nan) is nan); it stops on the NaN guard instead."""
    r = np.array([np.nan, 1.0, -2.0, 0.0, 3.0, np.nan])
    a = np.array([1.0, np.nan, 2.0, 1.0, -1.0, np.nan])
    b = np.array([2.0, 1.0, np.nan, 5.0, -3.0, 0.0])
    want = np.asarray((jnp.sign(r) * jnp.sign(a) * jnp.sign(b)) <= 0)
    tr_, ta, tb = map(torch.as_tensor, (r, a, b))
    got = (ts._nan_sign(tr_) * ts._nan_sign(ta) * ts._nan_sign(tb)) <= 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decade_points_equal_jax_pow(dtype):
    """The bracket endpoints are the values JAX's power gives (a one-ulp
    difference flips out-of-bracket Newton stops in float32)."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    got = ts._decade_table(-5.0, 11, tdt, "cpu").numpy()
    want = np.asarray(jnp.power(jnp.asarray(10.0, dtype),
                                -5.0 + jnp.arange(11).astype(dtype)))
    np.testing.assert_array_equal(got, want)


# --- routing to the REML kernel (ops/reml_kernel.py) --------------------------


def test_cpu_tensors_never_reach_the_kernel():
    """On the CPU every evaluation and the Wald step take the plain
    algebra: the kernel's launch counter does not move."""
    from pygemma_tpu_torch.core.assoc import assoc_block
    from pygemma_tpu_torch.ops import reml_kernel as rk

    ev, shared, v, permute, q = _gwas_block()
    assert ts.algebra(torch.zeros(1)) is ts.evaluate_plain
    t = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    before, evals = rk.reml_kernel.launches, ts.evaluate.count
    tsh, tv = t(shared), t(np.nan_to_num(v))
    ts.solve_lambda(ts.LambdaProblem(t(ev), tsh, t_pairs(tsh), tv, tv * tv,
                                     len(ev), q, permute, True), TCfg())
    assoc_block(t(ev), tsh[:, :-1], tsh[:, -1], tv, TCfg())
    assert ts.evaluate.count > evals
    assert rk.reml_kernel.launches == before


def _packed_block(s, dtype, B=4, n=30, seed=0):
    """Packed Grams of a block of B SNPs with s shared columns, and its
    per-SNP lambdas."""
    from pygemma_tpu_torch.core.grams import grams_per_snp_lambda_packed

    rng = np.random.default_rng(seed)
    sh = torch.as_tensor(rng.normal(size=(n, s)).astype(dtype))
    v = torch.as_tensor(rng.normal(size=(n, B)).astype(dtype))
    ev = torch.as_tensor(rng.uniform(size=n).astype(dtype))
    lam = torch.ones(B, dtype=sh.dtype)
    return grams_per_snp_lambda_packed(lam, ev, sh, t_pairs(sh), v, v * v,
                                       (1, 2)), lam


def test_the_width_rule_routes_wide_designs_to_pytorch():
    """The device alone routes: the PyTorch algebra takes every CPU input,
    wide designs included, and the kernel every CUDA input, float32 or
    float64, of any width.  A Gram wider than T_MAX is not refused: its
    library keeps the source's loops."""
    from types import SimpleNamespace

    from pygemma_tpu_torch.ops import reml_kernel as rk

    for dtype in (torch.float32, torch.float64):
        card = SimpleNamespace(is_cuda=True, dtype=dtype)
        assert ts.algebra(card) is rk.reml_kernel
        assert ts.algebra(torch.zeros(1, dtype=dtype)) is ts.evaluate_plain
    for t in (rk.T_MAX, rk.T_MAX + 1, 2 * rk.T_MAX):
        p, lam = _packed_block(t - 1, np.float32)
        _, got, dtype, _, _ = rk.kernel_args("d1", p, lam, n=30, q=t - 1,
                                             permute=True)
        assert (got, dtype) == (t, torch.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_the_kernel_wrapper_raises_off_the_card(dtype):
    """The wrapper launches or raises: CPU tensors (float32 and float64,
    the types it takes) are refused, as are other float types and mixed
    ones, before any launch."""
    from pygemma_tpu_torch.ops import reml_kernel as rk

    before = rk.reml_kernel.launches
    p, lam = _packed_block(4, dtype)
    kw = dict(n=30, q=4, permute=True)
    with pytest.raises(ValueError, match="CUDA"):
        rk.reml_kernel("d1", p, lam, **kw)
    half = p._replace(S=p.S.half(), vS=p.vS.half(), vv=p.vv.half())
    with pytest.raises(ValueError, match="float32 or float64"):
        rk.reml_kernel("d1", half, lam.half(), **kw)
    other = torch.float64 if dtype == np.float32 else torch.float32
    with pytest.raises(ValueError, match="one float type"):
        rk.reml_kernel("d1", p, lam.to(other), **kw)
    assert rk.reml_kernel.launches == before


def test_the_kernel_source_matches_the_wrapper():
    """T_MAX, the modes and the argument block's fields, read from the
    source (nvcc is not needed to know them), are the wrapper's: the
    library's T_MAX and the block's size are checked again when it is
    bound on the card, the fields' order only here."""
    import re

    from pygemma_tpu_torch.ops import reml_kernel as rk

    src = rk.SOURCE.read_text()
    assert int(re.search(r"#define REML_T_MAX (\d+)", src).group(1)) \
        == rk.T_MAX
    enum = re.search(r"enum Mode \{([^}]*)\}", src).group(1)
    modes = {k.strip().lower(): int(v) for k, v in
             (e.split("=") for e in enum.split(","))}
    assert modes == rk.MODES

    def fields(struct):
        body = re.search(rf"struct {struct} \{{(.*?)\n\}};", src, re.S)
        body = re.sub(r"//[^\n]*", "", body.group(1))
        names = []
        for decl in filter(None, (d.strip() for d in body.split(";"))):
            first, *rest = (x.strip() for x in decl.split(","))
            names += [re.split(r"[\s*]+", first)[-1]] + rest
        return names

    assert fields("View") == [f for f, _ in rk._View._fields_]
    assert fields("Args") == [f for f, _ in rk._Args._fields_]
