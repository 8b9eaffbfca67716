"""The port's pygemma table against pygemma_tpu.pygemma on the same inputs."""

import shutil

import numpy as np
import pytest
import torch

import oracle
import pygemma_tpu as pj
import pygemma_tpu_torch as pt
from pygemma_tpu_torch import api as tapi
from pygemma_tpu_torch.convert import eigen_from_numpy, null_fit_from_numpy
from pygemma_tpu_torch.core.eigen import rotate
from pygemma_tpu_torch.sim import simulate_gwas

torch.set_num_threads(2)

FLOWS = {
    "wald": {},
    "lrt_score": {"tests": ("wald", "lrt", "score")},
    "de": {"de": True},
    "grid": {"grid": True},
    "eigen_false": {"eigen": False},
}


@pytest.fixture(scope="module")
def data():
    y, G, W, K = oracle.simulate(n=220, p=40, c=3, seed=5)
    G[:, 7] = 0.0  # constant SNP: a full NaN row in both tables
    ev, U = np.linalg.eigh(K)
    return y, G, W, K, ev, U


def _args(data, flow, dtype):
    y, G, W, K, ev, U = data
    if flow != "eigen_false":
        return (y, G, W, K)
    # pre-rotated inputs, rotated by the port from the same eigenbasis
    ev_t, U_t = eigen_from_numpy(ev, U, device="cpu", dtype=dtype)
    rot = [rotate(U_t, torch.as_tensor(np.asarray(a, dtype))).numpy()
           for a in (y, G, W)]
    return (rot[0], rot[1], rot[2], ev_t.numpy())


def _compare(got, ref, dtype):
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref)
    for col in ref.columns:
        a, b = got[col].to_numpy(), ref[col].to_numpy()
        if a.dtype.kind not in "fc":
            np.testing.assert_array_equal(a, b)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=col)
        ok = ~np.isnan(b)
        if dtype == "float64":
            np.testing.assert_allclose(a[ok], b[ok], rtol=1e-6, atol=1e-12,
                                       err_msg=col)
        elif col.startswith("p_"):
            d = np.abs(np.log10(a[ok]) - np.log10(b[ok]))
            assert d.max() < 0.05, (col, d.max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("flow", list(FLOWS))
def test_table_matches_jax(data, flow, dtype):
    args = _args(data, flow, dtype)
    kw = dict(FLOWS[flow])
    ref = pj.pygemma(*args, config=pj.GwasConfig(dtype=dtype, snp_block=16),
                     **kw)
    got = pt.pygemma(*args, config=pt.GwasConfig(dtype=dtype, snp_block=16),
                     device="cpu", **kw)
    _compare(got, ref, dtype)
    if flow != "de":  # in DE mode the constant SNP is the outcome
        assert np.isnan(got["beta"][7]) and np.isnan(got["p_wald"][7])


def test_fused_switch_on_cpu_gives_the_same_table(data):
    """use_fused_kernel=True on CPU tensors takes the kernel's plain version:
    the table is identical to the unfused one."""
    y, G, W, K, _, _ = data
    cfg = pt.GwasConfig(snp_block=16, tests=("wald", "lrt"))
    a = pt.pygemma(y, G, W, K, config=cfg.replace(use_fused_kernel=True),
                   device="cpu")
    b = pt.pygemma(y, G, W, K, config=cfg.replace(use_fused_kernel=False),
                   device="cpu")
    np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())


def test_multi_phenotype_and_snp_names():
    """k=3 phenotypes: both packages take their batched route; the tables
    agree."""
    sim = simulate_gwas(n=150, p=20, c=2, seed=3, dtype=np.float64)
    rng = np.random.default_rng(0)
    Y = np.c_[sim.Y, rng.normal(size=(150, 2))]
    names = [f"rs{i}" for i in range(20)]
    ref = pj.pygemma(Y, sim.X, sim.W, sim.K, snps=names,
                     config=pj.GwasConfig(dtype="float64"))
    got = pt.pygemma(Y, sim.X, sim.W, sim.K, snps=names,
                     config=pt.GwasConfig(dtype="float64"), device="cpu")
    _compare(got, ref, "float64")


def test_matches_float64_oracle(data):
    y, G, W, K, ev, U = data
    ev = np.maximum(ev, 0.0)
    ref = oracle.assoc_scan(ev, U.T @ W, U.T @ y, (U.T @ G)[:, :6])
    got = pt.pygemma(y, G[:, :6], W, K, config=pt.GwasConfig(dtype="float64"),
                     device="cpu")
    np.testing.assert_allclose(got["beta"], ref["beta"], rtol=1e-6)
    np.testing.assert_allclose(got["p_wald"], ref["p_wald"], rtol=1e-6)


def test_run_dir_reuses_the_jax_eigenbasis(data, tmp_path, monkeypatch):
    """The eigen file the JAX package writes is found by the port (same
    fingerprint key) and no eigendecomposition runs."""
    y, G, W, K, _, _ = data
    cfg = dict(dtype="float64", snp_block=16)
    ref = pj.pygemma(y, G, W, K, config=pj.GwasConfig(**cfg),
                     run_dir=str(tmp_path / "jax"))
    (tmp_path / "port").mkdir()
    shutil.copy(tmp_path / "jax" / "eigen.npz", tmp_path / "port")

    def no_eigh(*a, **k):
        raise AssertionError("the cached eigenbasis was not reused")

    monkeypatch.setattr(tapi, "auto_eigendecompose", no_eigh)
    tapi._EIGEN_DEV_CACHE.clear()
    got = pt.pygemma(y, G, W, K, config=pt.GwasConfig(**cfg),
                     run_dir=str(tmp_path / "port"), device="cpu")
    _compare(got, ref, "float64")
    # a resumed run reads its saved blocks back
    again = pt.pygemma(y, G, W, K, config=pt.GwasConfig(**cfg),
                       run_dir=str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(again.to_numpy(), got.to_numpy())


def test_estimate_lambda_and_null_fit(data):
    from pygemma_tpu.api import _fit_null_jit
    import jax.numpy as jnp

    y, G, W, K, ev, U = data
    ev = np.maximum(ev, 0.0)
    Wr, yr = U.T @ W, U.T @ y
    cfg64 = dict(dtype="float64")
    a = pj.estimate_lambda(ev, yr, Wr, config=pj.GwasConfig(**cfg64))
    b = pt.estimate_lambda(ev, yr, Wr, config=pt.GwasConfig(**cfg64),
                           device="cpu")
    np.testing.assert_allclose(b, a, rtol=1e-8)
    jarr = np.asarray(_fit_null_jit(jnp.asarray(ev), jnp.asarray(Wr),
                                    jnp.asarray(yr), pj.GwasConfig(**cfg64)))
    nf = null_fit_from_numpy(jarr)
    tarr = tapi._fit_null(torch.as_tensor(ev), torch.as_tensor(Wr),
                          torch.as_tensor(yr), pt.GwasConfig(**cfg64))
    np.testing.assert_allclose(tarr.numpy(), jarr, rtol=1e-8)
    assert float(nf.loglik_ml) == jarr[2]
