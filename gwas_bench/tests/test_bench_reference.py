"""The plain reference against the dense float64 oracle (tests/oracle.py)
on tiny fixtures: a dense K and a low-rank GRM plus ridge."""

import sys

import numpy as np
import pytest
import torch

from conftest import ROOT
from gwas_bench.reference import lmm

sys.path.insert(0, str(ROOT / "tests"))
import oracle  # noqa: E402

COLS = ("beta", "se_beta", "tau", "lambda", "p_wald")


def _close(got, ref):
    for col in COLS:
        np.testing.assert_allclose(got[col], ref[col], rtol=1e-8, err_msg=col)


@pytest.mark.parametrize("seed", [0, 3])
def test_dense(seed):
    y, G, W, K = oracle.simulate(n=240, p=10, c=3, seed=seed)
    ev, U = np.linalg.eigh(K)
    ref = oracle.assoc_scan(np.maximum(ev, 0), U.T @ W, U.T @ y, U.T @ G)
    space = lmm.dense_eigenspace(torch.as_tensor(K), "float64")
    got = lmm.scan(space, torch.as_tensor(W), torch.as_tensor(G),
                   torch.as_tensor(np.repeat(y[:, None], 10, 1)))
    _close(got, ref)


def test_lowrank_with_complement():
    rng = np.random.default_rng(1)
    n, pk = 300, 48
    codes = rng.binomial(2, 0.3, size=(n, pk + 8)).astype(np.float64)
    Gs = (codes - codes.mean(0)) / codes.std(0)
    Gc = Gs[:, :pk] - Gs[:, :pk].mean(0)
    K = Gc @ Gc.T / pk + 1e-3 * np.eye(n)
    W = np.c_[np.ones(n), rng.normal(size=(n, 2))]
    y = Gs[:, :4].sum(1) * 0.4 + rng.normal(size=n)
    X = Gs[:, pk - 4:]  # kinship SNPs and SNPs outside it
    ev, U = np.linalg.eigh(K)
    ref = oracle.assoc_scan(np.maximum(ev, 0), U.T @ W, U.T @ y, U.T @ X)
    space = lmm.lowrank_eigenspace(torch.as_tensor(Gs[:, :pk]), 1e-3,
                                   "float64")
    assert space.n_comp == n - pk
    Y = torch.as_tensor(np.repeat(y[:, None], X.shape[1], 1))
    got = lmm.scan(space, torch.as_tensor(W), torch.as_tensor(X), Y)
    _close(got, ref)
    # judged against itself, every gap is at float64 round-off
    res = lmm.judge(space, torch.as_tensor(W), torch.as_tensor(X), Y, got)
    assert res["z_err"].max() < 1e-10 and res["se_err"].max() < 1e-10
    assert np.abs(res["loglik_gap"]).max() < 1e-8


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0e-5,
                      1.0 + 2.0 ** -10])
    r = lmm.to_tf32(x)
    # ties go to the even mantissa; 10 bits are kept
    assert r.tolist() == [1.0, 1.0, 1.0 + 2.0 ** -9, float(r[3]),
                          1.0 + 2.0 ** -10]
    assert abs(float(r[3]) / -3.0e-5 - 1) < 2.0 ** -11
