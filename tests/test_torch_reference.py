"""The port against the reference-authored goldens and the edge cases.

tests/test_reference_parity.py's golden cases (grid lambda and statistics
against tests/golden/ref_parity_n200_p40_c3_seed77.csv, generated from the
reference's own code; LRT/score against the independent dense-H brute
maximization in lrt_score_golden_n200_p40_c3_seed99.csv) and
tests/test_robustness.py's edge cases, run on the port on the CPU.  The
tolerances are the agreement a first run of these cases reached (grid lambda
equal, float64 p_wald 2.5e-14 relative, LRT/score 1.4e-7 relative, float32
|d log10 p| 9.5e-6 against the golden and 5.6e-5 against float64), with
headroom.
"""

import csv
import os

import numpy as np
import pytest
import torch

import oracle
import pygemma_tpu_torch as pt
from pygemma_tpu_torch.preprocess import genomic_control_lambda

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
N, P, C = 200, 40, 3
CFG64 = pt.GwasConfig(dtype="float64", snp_block=64)


def _scan(*args, **kw):
    return pt.pygemma(*args, device="cpu", **kw)


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name)) as fh:
        rows = [r for r in csv.DictReader(fh) if not r["snp"].startswith("#")]
    return {k: np.array([float(r[k]) for r in rows])
            for k in rows[0] if k != "snp"}


def _neglog10(p):
    return -np.log10(np.maximum(np.asarray(p, np.float64), 1e-300))


@pytest.fixture(scope="module")
def grid_case():
    return (oracle.simulate(n=N, p=P, c=C, seed=77),
            _golden("ref_parity_n200_p40_c3_seed77.csv"))


def test_grid_lambda_and_stats_match_golden(grid_case):
    (y, G, W, K), golden = grid_case
    df = _scan(y, G, W, K, config=CFG64.replace(grid=True))
    np.testing.assert_allclose(df["lambda"], golden["lambda_grid"],
                               rtol=1e-12)
    for col in ("beta", "se_beta", "tau", "F_wald", "p_wald"):
        np.testing.assert_allclose(df[col], golden[col], rtol=1e-10,
                                   err_msg=col)


def test_float32_tracks_golden(grid_case):
    (y, G, W, K), golden = grid_case
    df = _scan(y, G, W, K, config=pt.GwasConfig(dtype="float32",
                                                snp_block=64, grid=True))
    np.testing.assert_allclose(df["lambda"], golden["lambda_grid"],
                               rtol=1e-6)
    np.testing.assert_allclose(df["beta"], golden["beta"], rtol=5e-3,
                               atol=1e-6)
    np.testing.assert_allclose(df["se_beta"], golden["se_beta"], rtol=5e-3)
    d = np.abs(_neglog10(df["p_wald"]) - _neglog10(golden["p_wald"]))
    assert d.max() < 1e-3, d.max()


def test_lrt_score_match_independent_golden():
    golden = _golden("lrt_score_golden_n200_p40_c3_seed99.csv")
    y, G, W, K = oracle.simulate(n=N, p=P, c=C, seed=99)
    df = _scan(y, G, W, K, config=CFG64, tests=("wald", "lrt", "score"))
    np.testing.assert_allclose(df["lambda"], golden["lambda_reml"],
                               rtol=2e-4)
    np.testing.assert_allclose(df["lambda_ml"], golden["lambda_ml"],
                               rtol=2e-4)
    for col in ("beta", "se_beta", "p_wald", "p_score"):
        np.testing.assert_allclose(df[col], golden[col], rtol=1e-6,
                                   err_msg=col)
    np.testing.assert_allclose(df["logl_H1"], golden["logl_H1"], rtol=1e-9)
    np.testing.assert_allclose(df["p_lrt"], golden["p_lrt"], rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("n,p,c", [(60, 1, 1), (50, 3, 1), (80, 130, 2)])
def test_odd_shapes(n, p, c):
    y, G, W, K = oracle.simulate(n=n, p=max(p, 40), c=c, seed=n + p)
    df = _scan(y, G[:, :p], W, K, config=CFG64)
    assert len(df) == p
    assert np.isfinite(df["p_wald"]).all()


def test_single_block_larger_than_p():
    y, G, W, K = oracle.simulate(n=70, p=10, c=2, seed=3)
    df = _scan(y, G, W, K, config=pt.GwasConfig(dtype="float64",
                                                snp_block=4096))
    assert len(df) == 10 and np.isfinite(df["p_wald"]).all()


def test_null_phenotype_calibration():
    """A pure-noise phenotype with real relatedness: p uniform, lambda_GC
    near 1."""
    rng = np.random.default_rng(12)
    n, p = 300, 400
    G = rng.binomial(2, rng.uniform(0.1, 0.5, p)[None, :], (n, p)).astype(float)
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-6)
    K = G @ G.T / p + 1e-4 * np.eye(n)
    u = rng.multivariate_normal(np.zeros(n), K)
    y = 0.6 * u + 0.8 * rng.normal(size=n)
    df = _scan(y, G, np.ones((n, 1)), K, config=CFG64)
    lam_gc = genomic_control_lambda(df["p_wald"])
    assert 0.7 < lam_gc < 1.3, lam_gc
    h, _ = np.histogram(df["p_wald"], bins=10, range=(0, 1))
    assert h.max() < 2.5 * h.mean()


def test_extreme_heritability_lambda_endpoints():
    """Nearly pure genetic and nearly pure noise phenotypes drive lambda to
    the bracket's ends without NaNs."""
    rng = np.random.default_rng(5)
    n, p = 150, 30
    G = rng.normal(size=(n, p))
    K = G @ G.T / p + 1e-3 * np.eye(n)
    W = np.ones((n, 1))
    u = rng.multivariate_normal(np.zeros(n), K)
    df_hi = _scan(u + 1e-3 * rng.normal(size=n), G, W, K, config=CFG64)
    assert np.isfinite(df_hi["p_wald"]).all()
    assert (df_hi["lambda"] > 1e3).mean() > 0.5
    df_lo = _scan(rng.normal(size=n), G, W, np.eye(n) * 1.0 + 0.001 * K,
                  config=CFG64)
    assert np.isfinite(df_lo["p_wald"]).all()


def test_constant_phenotype_no_crash():
    y, G, W, K = oracle.simulate(n=80, p=8, c=1, seed=8)
    df = _scan(np.ones(80), G, W, K, config=CFG64)
    assert len(df) == 8  # the statistics are meaningless; no exception


def test_float32_vs_float64_consistency_moderate_scale():
    y, G, W, K = oracle.simulate(n=400, p=64, c=3, seed=44)
    df32 = _scan(y, G, W, K, config=pt.GwasConfig(dtype="float32",
                                                  snp_block=64))
    df64 = _scan(y, G, W, K, config=CFG64)
    d = np.abs(_neglog10(df32["p_wald"]) - _neglog10(df64["p_wald"]))
    assert np.nanmax(d) < 1e-3, np.nanmax(d)
