"""Port REML/ML algebra (pygemma_tpu_torch.core.reml) against the JAX one,
and torch.autograd against the hand-written derivatives."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from pygemma_tpu.core import reml as jr
from pygemma_tpu.core.grams import grams_per_snp_lambda as j_gpsl
from pygemma_tpu.core.grams import pair_products as j_pairs
from pygemma_tpu.core.grams import permute_x_before_y as j_perm
from pygemma_tpu_torch.core import reml as tr
from pygemma_tpu_torch.core.grams import grams_per_snp_lambda as t_gpsl
from pygemma_tpu_torch.core.grams import pair_products as t_pairs
from pygemma_tpu_torch.core.grams import permute_x_before_y as t_perm
from pygemma_tpu_torch.core.solver import LambdaProblem, evaluate

torch.set_num_threads(2)
RTOL = 1e-10


@pytest.fixture(scope="module")
def data():
    y, G, W, K = oracle.simulate(n=150, p=10, c=3, seed=11)
    ev, U = np.linalg.eigh(K)
    return np.maximum(ev, 0.0), U.T @ W, U.T @ y, U.T @ G


@pytest.fixture(scope="module")
def grams(data):
    """The same float64 Grams (A1, A2, A3, sums) in both frameworks."""
    ev, W, y, X = data
    lam = np.power(10.0, np.linspace(-3, 3, X.shape[1]))
    c = W.shape[1]
    sj = jnp.asarray(np.c_[W, y])
    gj, sums_j = j_gpsl(jnp.asarray(lam), jnp.asarray(ev), sj, j_pairs(sj),
                        jnp.asarray(X), jnp.asarray(X * X), (1, 2, 3),
                        want_logh=True)
    st = torch.as_tensor(np.c_[W, y])
    Xt = torch.as_tensor(X)
    gt, sums_t = t_gpsl(torch.as_tensor(lam), torch.as_tensor(ev), st,
                        t_pairs(st), Xt, Xt * Xt, (1, 2, 3), want_logh=True)
    gj = [j_perm(A, c) for A in gj]
    gt = [t_perm(A, c) for A in gt]
    return lam, c, (gj, sums_j), (gt, sums_t)


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a.detach().numpy()), np.asarray(b),
                               rtol=rtol, atol=0)


def test_small_cholesky_and_solve(grams):
    _, c, (gj, _), (gt, _) = grams
    Lj = jr.small_cholesky(gj[0][..., :c + 1, :c + 1])
    Lt = tr.small_cholesky(gt[0][..., :c + 1, :c + 1])
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=RTOL,
                               atol=1e-14)
    rhs = np.random.default_rng(0).normal(size=(Lt.shape[0], c + 1, 2))
    np.testing.assert_allclose(
        tr.chol_solve(Lt, torch.as_tensor(rhs)).numpy(),
        np.asarray(jr.chol_solve(Lj, jnp.asarray(rhs))), rtol=RTOL)


def test_pivot_clamp_matches(grams):
    """A rank-deficient design hits the MIN_VAL pivot clamp identically."""
    G = np.ones((2, 3, 3))
    G[1] = np.diag([1.0, 0.0, 2.0])
    np.testing.assert_allclose(
        tr.small_cholesky(torch.as_tensor(G)).numpy(),
        np.asarray(jr.small_cholesky(jnp.asarray(G))), rtol=RTOL)


@pytest.mark.parametrize("need_third", [False, True])
def test_reml_scalars(grams, need_third):
    _, c, (gj, sj), (gt, st) = grams
    a = jr.reml_scalars(*gj, sj, c + 1, need_third=need_third)
    b = tr.reml_scalars(*gt, st, c + 1, need_third=need_third)
    for x, y in zip(b, a):
        if y is None:
            assert x is None
        else:
            _close(x, y)


def test_predictor_terms(grams):
    _, c, (gj, _), (gt, _) = grams
    for x, y in zip(tr.predictor_terms(gt[0], c), jr.predictor_terms(gj[0], c)):
        _close(x, y)


@pytest.mark.parametrize("family", ["restricted", "ml"])
def test_likelihood_and_derivatives(grams, family):
    lam, c, (gj, sj), (gt, st) = grams
    n, q = 150, c + 1
    a = jr.reml_scalars(*gj, sj, q, need_third=True)
    b = tr.reml_scalars(*gt, st, q, need_third=True)
    lj, lt = jnp.asarray(lam), torch.as_tensor(lam)
    if family == "restricted":
        pairs = [
            (tr.loglik_restricted(lt, n, q, b.yPy, st.sum_logh, b.logdet_G1),
             jr.loglik_restricted(lj, n, q, a.yPy, sj.sum_logh, a.logdet_G1)),
            (tr.d1_restricted(lt, n, q, b.yPy, b.yPPy, b.trP),
             jr.d1_restricted(lj, n, q, a.yPy, a.yPPy, a.trP)),
            (tr.d2_restricted(lt, n, q, b.yPy, b.yPPy, b.yPPPy, b.trP, b.trPP),
             jr.d2_restricted(lj, n, q, a.yPy, a.yPPy, a.yPPPy, a.trP, a.trPP)),
        ]
    else:
        pairs = [
            (tr.loglik_ml(lt, n, b.yPy, st.sum_logh),
             jr.loglik_ml(lj, n, a.yPy, sj.sum_logh)),
            (tr.d1_ml(lt, n, b.yPy, b.yPPy, st.sum_d),
             jr.d1_ml(lj, n, a.yPy, a.yPPy, sj.sum_d)),
            (tr.d2_ml(lt, n, b.yPy, b.yPPy, b.yPPPy, st.sum_d, st.sum_d2),
             jr.d2_ml(lj, n, a.yPy, a.yPPy, a.yPPPy, sj.sum_d, sj.sum_d2)),
        ]
    for x, y in pairs:
        _close(x, y)


def test_clamps_match_on_degenerate_scalars():
    """Negative / zero / NaN quadratic forms hit the same clamps, including
    the asymmetric max(yPPy, 0) of d1_restricted."""
    yPy = np.array([-1.0, 0.0, 2.0, np.nan, 3.0])
    yPPy = np.array([0.5, -2.0, -1e-3, 1.0, np.nan])
    trP = np.array([3.0, 4.0, 5.0, 6.0, 7.0])
    lam = np.array([0.1, 1.0, 10.0, 2.0, 3.0])
    t = [torch.as_tensor(a) for a in (lam, yPy, yPPy, trP)]
    j = [jnp.asarray(a) for a in (lam, yPy, yPPy, trP)]
    np.testing.assert_array_equal(tr.d1_restricted(t[0], 50, 3, *t[1:]).numpy(),
                                  np.asarray(jr.d1_restricted(j[0], 50, 3, *j[1:])))
    np.testing.assert_array_equal(
        tr.loglik_ml(t[0], 50, t[1], t[3]).numpy(),
        np.asarray(jr.loglik_ml(j[0], 50, j[1], j[3])))


@pytest.mark.parametrize("restricted", [True, False])
def test_autodiff_consistency(data, restricted):
    """d1/d2 hand-derived forms agree with torch.autograd of ell (and of
    d1), as test_reml_core.py::test_autodiff_consistency does for jax."""
    ev, W, y, X = data
    n, c = W.shape
    shared = torch.as_tensor(np.c_[W, y])
    v = torch.as_tensor(X[:, :3])
    prob = LambdaProblem(torch.as_tensor(ev), shared, t_pairs(shared), v,
                         v * v, n, c + 1, True, restricted)
    for lam in [0.05, 2.0, 300.0]:
        lam_t = torch.tensor(lam, dtype=torch.float64, requires_grad=True)
        lik = evaluate(prob, lam_t, "lik", True)
        g = torch.stack([torch.autograd.grad(lik[i], lam_t, retain_graph=True)[0]
                         for i in range(3)])
        d1, d2 = evaluate(prob, lam_t, "newton", True)
        np.testing.assert_allclose(g.numpy(), d1.detach().numpy(), rtol=1e-5,
                                   atol=1e-9)
        h = torch.stack([torch.autograd.grad(d1[i], lam_t, retain_graph=True)[0]
                         for i in range(3)])
        np.testing.assert_allclose(h.numpy(), d2.detach().numpy(), rtol=1e-5,
                                   atol=1e-9)
