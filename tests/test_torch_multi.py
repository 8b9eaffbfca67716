"""The port's batched multi-phenotype scan against the JAX package's.

``assoc_block_multi`` and ``fit_null_multi`` (dense, and implicit with
``ImplicitMultiCtx``) are fed the same rotated float64 inputs in both
packages; ``pygemma``'s batched table (k >= 3, no run_dir) is held to the
JAX package's for Wald/LRT/score, DE, grid and the implicit low-rank path,
to the port's own looped table, and to itself with the fused switch on.

Every JAX reference is computed in one child process: compiling the JAX
package's vmapped multi-phenotype graphs in the test worker has left
XLA:CPU in a state that segfaults a later compile (tests/test_implicit.py,
``_MULTIPHENO_CHILD``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle
import pygemma_tpu_torch as pt
from pygemma_tpu_torch import api as tapi
from pygemma_tpu_torch.core import assoc as tassoc
from test_torch_api import _compare
from test_torch_lowrank import _close_stats

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS3 = ("wald", "lrt", "score")
EPS = 1e-3
#: table-level flows: (config fields, pygemma keywords, implicit K?)
FLOWS = {
    "lrt_score": ({"tests": TESTS3}, {}, False),
    "de": ({}, {"de": True}, False),
    "grid": ({}, {"grid": True}, False),
    "implicit_lrt_score": ({"tests": TESTS3}, {}, True),
}
#: the JAX side runs at k = 4; its vmap treats phenotypes independently,
#: so its first three rows are its k = 3 result
FN_CASES = [("dense", 3), ("dense", 4), ("implicit", 3), ("implicit", 4)]
P_K = 24  # the implicit kinship's SNPs: its top space has 24 dimensions
#: the JAX package's vmapped batched scan runs blocks of max(128,
#: snp_block // k) columns; the function-level inputs have that width (the
#: SNPs zero-padded: NaN rows), so the child reuses pygemma's executables
B_JAX = 128

_CHILD = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, sys.argv[3])
import jax.numpy as jnp
from pygemma_tpu import GwasConfig, LowRankKinship, pygemma
from pygemma_tpu import api

FLOWS = %(flows)r
d = dict(np.load(sys.argv[1]))
out = {}
for flow, (fields, kw, implicit) in FLOWS.items():
    K = (LowRankKinship(d["G_k"], eps=float(d["eps"])) if implicit
         else d["K"])
    X = d["X_i"] if implicit else d["G"]
    df = pygemma(d["Y"], X, d["W"], K,
                 snps=[f"rs{i}" for i in range(X.shape[1])],
                 config=GwasConfig(snp_block=16, dtype="float64", **fields),
                 **kw)
    for col in df.columns:
        v = df[col].to_numpy()
        out[f"tab_{flow}_{col}"] = v.astype(str) if v.dtype == object else v
    out[f"tab_{flow}__columns"] = np.asarray(list(df.columns))

# assoc_block_multi / fit_null_multi through the jitted wrappers that
# pygemma uses, with the lrt_score flows' shapes, dtypes, settings and device
# placement (jit's cache key holds whether an input is committed to a
# device, as pygemma's streamed and computed arrays are), so the
# executables compiled above serve them
cfg = GwasConfig(snp_block=16, dtype="float64", tests=("wald", "lrt", "score"))
dev = lambda a: jax.device_put(a, jax.devices()[0])
for kind in ("dense", "implicit"):
    name = lambda k: d[f"{kind}_{k}"]
    if kind == "dense":
        a = [jnp.asarray(name(k)) for k in ("ev", "W", "Y_kn")]
        a.append(dev(name("X")))
        null = api._fit_null_multi_jit(*a[:3], cfg)
        res = api._assoc_multi_jit(*a, cfg, null, False, True)
    else:
        # pygemma's top-space eigenvalues are float32
        a = [dev(name("ev").astype(np.float32))]
        a += [dev(name(k)) for k in ("W", "Y_kn", "X")]
        eps = jnp.asarray(d["eps"])
        f = [jnp.asarray(name(k)) for k in ("WtW", "WtY", "YtY")]
        f += [dev(name(k)) for k in ("XtW", "XtY", "vv")]
        n_total = int(d["n_total"])
        null = api._fit_null_multi_implicit_jit(*a[:3], cfg, eps, *f[:3],
                                                n_total)
        res = api._assoc_multi_implicit_jit(*a, cfg, null, False, True, eps,
                                            *f, n_total)
    out[f"fn_{kind}_null"] = np.asarray(null)
    out[f"fn_{kind}_stack"] = np.asarray(res)
np.savez(sys.argv[2], **out)
"""


def _rotated(U, *arrays):
    return [U.T @ a for a in arrays]


@pytest.fixture(scope="module")
def inputs():
    """Dense: oracle.simulate with a constant SNP, four phenotypes.
    Implicit: a 24-SNP kinship G_k (K = G_k G_k'/24 + 1e-3 I) and 30 test
    SNPs; a random orthonormal top basis for the function-level case."""
    rng = np.random.default_rng(41)
    y, G, W, K = oracle.simulate(n=120, p=40, c=3, seed=17)
    G[:, 7] = 0.0  # constant SNP: a full NaN row for every phenotype
    n = y.shape[0]
    Y = np.c_[y, 0.5 * y + rng.standard_normal(n), rng.standard_normal(n),
              G[:, 3] + rng.standard_normal(n)]
    d = {"Y": Y, "G": G, "W": W, "K": K, "eps": np.float64(EPS),
         "n_total": np.int64(n)}
    ev, U = np.linalg.eigh(K)
    pad = np.zeros((n, B_JAX - G.shape[1]))
    Wr, Yr, Gr = _rotated(U, W, Y, np.c_[G, pad])
    d.update(dense_ev=np.maximum(ev, 0.0), dense_W=Wr, dense_Y_kn=Yr.T,
             dense_X=Gr)
    G_k = rng.binomial(2, 0.3, size=(n, P_K)).astype(np.float64)
    G_k = (G_k - G_k.mean(0)) / np.maximum(G_k.std(0), 1e-6)
    X_i = rng.binomial(2, 0.4, size=(n, 30)).astype(np.float64)
    X_i = (X_i - X_i.mean(0)) / np.maximum(X_i.std(0), 1e-6)
    d.update(G_k=G_k, X_i=X_i)
    # function level: any orthonormal (n, p_k) basis and positive spectrum
    U_top, _ = np.linalg.qr(rng.standard_normal((n, P_K)))
    xb = np.c_[X_i, np.zeros((n, B_JAX - X_i.shape[1]))]
    # float32 values: the JAX package's top-space eigenvalues are float32
    ev_top = np.sort(rng.uniform(0.2, 5.0, P_K)).astype(np.float32)
    d.update(implicit_ev=ev_top.astype(np.float64),
             implicit_W=U_top.T @ W, implicit_Y_kn=(U_top.T @ Y).T,
             implicit_X=U_top.T @ xb, implicit_WtW=W.T @ W,
             implicit_WtY=W.T @ Y, implicit_YtY=np.sum(Y * Y, axis=0),
             implicit_XtW=xb.T @ W, implicit_XtY=xb.T @ Y,
             implicit_vv=np.sum(xb * xb, axis=0))
    return d


@pytest.fixture(scope="module")
def jax_ref(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multi")
    inp, outp = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(inp, **inputs)
    code = _CHILD % {"flows": FLOWS}
    r = subprocess.run([sys.executable, "-c", code, inp, outp, ROOT],
                       capture_output=True, text=True, timeout=540)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(outp))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _port_implicit_ctx(d, k, null_only=False):
    m = tassoc.ImplicitMultiCtx(
        _t(d["eps"]), int(d["n_total"]), _t(d["implicit_WtW"]),
        _t(d["implicit_WtY"][:, :k]), _t(d["implicit_YtY"][:k]),
        _t(d["implicit_XtW"]), _t(d["implicit_XtY"][:, :k]),
        _t(d["implicit_vv"]))
    if null_only:
        m = m._replace(XtW=torch.zeros((1, m.WtW.shape[0]), dtype=torch.float64),
                       XtY=torch.zeros((1, k), dtype=torch.float64),
                       vv=torch.zeros((1,), dtype=torch.float64))
    return m


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-6, atol=1e-12,
                               err_msg=what)


def _jax_keys():
    """The stacked rows of the JAX package's ``_assoc_multi_jit``."""
    return ["beta", "se_beta", "tau", "lam", "F_wald", "lambda_ml",
            "logl_H1", "F_score"]


@pytest.mark.parametrize("kind,k", FN_CASES)
def test_fit_null_multi_matches_jax(inputs, jax_ref, kind, k):
    d = inputs
    cfg = pt.GwasConfig(dtype="float64", tests=TESTS3)
    m = _port_implicit_ctx(d, k, null_only=True) if kind == "implicit" \
        else None
    got = tassoc.fit_null_multi(_t(d[f"{kind}_ev"]), _t(d[f"{kind}_W"]),
                                _t(d[f"{kind}_Y_kn"][:k]), cfg, m)
    assert got.shape == (k, 3)
    _close(got.numpy(), jax_ref[f"fn_{kind}_null"][:k], "null")


@pytest.mark.parametrize("kind,k", FN_CASES)
def test_assoc_block_multi_matches_jax(inputs, jax_ref, kind, k):
    """Same rotated inputs and the JAX null rows: every (k, B) statistic
    agrees in float64; the port's p-values are the table's (scipy)."""
    d = inputs
    cfg = pt.GwasConfig(dtype="float64", snp_block=16, tests=TESTS3)
    m = _port_implicit_ctx(d, k) if kind == "implicit" else None
    res = tassoc.assoc_block_multi(
        _t(d[f"{kind}_ev"]), _t(d[f"{kind}_W"]), _t(d[f"{kind}_Y_kn"][:k]),
        _t(d[f"{kind}_X"]), cfg, null_stack=_t(jax_ref[f"fn_{kind}_null"][:k]),
        implicit_multi=m)
    assert sorted(res) == sorted(_jax_keys() + ["p_wald", "p_lrt",
                                                "p_score"])
    ref = dict(zip(_jax_keys(), jax_ref[f"fn_{kind}_stack"]))
    for key, v in res.items():
        assert v.shape == (k, B_JAX), key
        if key in ref:
            _close(v.numpy(), ref[key][:k], key)
    # the LRT's chi^2 survival runs on the device: held to scipy
    from scipy import stats

    D = 2.0 * (ref["logl_H1"][:k] - jax_ref[f"fn_{kind}_null"][:k, 2:3])
    _close(res["p_lrt"].numpy(), stats.chi2.sf(D, 1), "p_lrt")


def _port_table(d, flow, **kw):
    fields, pkw, implicit = FLOWS[flow]
    fields = dict(fields)
    fields.setdefault("dtype", "float64")
    K = pt.LowRankKinship(d["G_k"], eps=EPS) if implicit else d["K"]
    X = d["X_i"] if implicit else d["G"]
    cfg = pt.GwasConfig(snp_block=16, **fields)
    return pt.pygemma(d["Y"], X, d["W"], K, config=cfg, device="cpu",
                      snps=[f"rs{i}" for i in range(X.shape[1])],
                      **pkw, **kw), fields["dtype"]


@pytest.mark.parametrize("flow", list(FLOWS))
def test_batched_table_matches_jax(inputs, jax_ref, flow):
    import pandas as pd

    got, dtype = _port_table(inputs, flow)
    cols = list(jax_ref[f"tab_{flow}__columns"])
    ref = pd.DataFrame({c: jax_ref[f"tab_{flow}_{c}"] for c in cols})
    if FLOWS[flow][2]:
        # both packages build the low-rank basis in float32
        assert list(got.columns) == cols
        _close_stats(got, ref, cols=("p_wald", "p_lrt", "p_score"))
    else:
        _compare(got, ref, dtype)
    assert sorted(set(got["pheno"])) == [0, 1, 2, 3]
    if flow not in ("de",) and not FLOWS[flow][2]:
        # the constant SNP is a NaN row for every phenotype
        assert got.loc[got["SNPs"] == "rs7", "beta"].isna().all()


def _count_rotations(fn):
    before = tapi._rotate_top.count
    out = fn()
    return out, tapi._rotate_top.count - before


@pytest.mark.parametrize("flow", ["lrt_score", "implicit_lrt_score"])
def test_batched_matches_looped(inputs, flow, tmp_path):
    """run_dir forces the looped scan: the same table within the float64
    tolerance, and on the implicit path k rotations of each block become
    one."""
    p = (inputs["X_i"] if FLOWS[flow][2] else inputs["G"]).shape[1]
    blocks = -(-p // 16)
    (batched, dtype), r_b = _count_rotations(
        lambda: _port_table(inputs, flow))
    (looped, _), r_l = _count_rotations(
        lambda: _port_table(inputs, flow, run_dir=str(tmp_path / "rd")))
    _compare(batched, looped, dtype)
    if FLOWS[flow][2]:
        assert (r_b, r_l) == (blocks, 4 * blocks)
    else:
        assert (r_b, r_l) == (0, 0)


def test_fused_switch_on_cpu_gives_the_same_batched_table(inputs):
    """use_fused_kernel=True on CPU tensors takes the kernel's plain
    version in every phenotype's evaluations: the identical table."""
    d = inputs
    cfg = pt.GwasConfig(snp_block=16, tests=("wald", "lrt"))
    a = pt.pygemma(d["Y"], d["G"], d["W"], d["K"],
                   config=cfg.replace(use_fused_kernel=True), device="cpu")
    b = pt.pygemma(d["Y"], d["G"], d["W"], d["K"],
                   config=cfg.replace(use_fused_kernel=False), device="cpu")
    np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
