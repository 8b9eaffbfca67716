"""The sample-sharded eigendecomposition (``parallel/dist.py::
sharded_eigh_fn``: ``core/eigh_dc.py`` on row slabs, ``parallel/slabs.py``)
on the CPU, over one gloo group of four rank processes.

(a) The sharded function alone, on meshes ``sample=4, snp=1`` and
``sample=2, snp=2``, on float64 matrices at n = 301 (uneven slabs) with a
small ``max_block``, so that the root and depth-1 splits run sharded: a
two-level Gram, a wide spectrum, and a Gram whose degenerate cluster spans
the median (the forced half split).  Held to the one-process ``eigh_dc``
on the same matrix (the same r_lo at every depth, read from the
``PYGEMMA_TPU_DC_VERBOSE`` lines; eigenvalues within 1e-10 of max|ev|), at
n = 300 to the JAX package's ``sharded_eigh_fn`` on ``make_mesh(snp=2,
sample=4)`` (eigenvalues only, within 1e-10 of max|ev|: ROADMAP's parity
rule compares no eigenvectors), and in float32 to tests/test_eigh_dc.py's
certificate.  Every rank returns the same (ev, U) bytes, and no rank holds
a whole n x n sign iterate.
(b) ``pygemma(..., mesh=make_mesh(snp=2, sample=2))`` on a dense K with
splits forced, against the JAX package's mesh scan on the same inputs:
float64 rtol 1e-6 on every statistic, float32 |d log10 p| < 0.05; every
rank's table identical.
(c) A split that fails raises on every rank, the ``snp`` ranks included.

The four ranks and one child running every JAX reference start once for
the module, side by side; the group's collectives time out after 180 s.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import oracle
from pygemma_tpu_torch.core import eigh_dc as tdc
from pygemma_tpu_torch.parallel import distributed
from pygemma_tpu_torch.parallel.slabs import bounds
from test_torch_api import _compare
from test_torch_eigh_dc import _check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESHES = {"sample4": (4, 1), "sample2_snp2": (2, 2)}  # (sample, snp)
MAX_BLOCK = 64
EV_TOL = 1e-10  # times max|ev|, float64
SCAN_BLOCK = 48  # max_block of the forced splits under pygemma (n = 150)


def _gram(n, p, seed):
    G = np.random.default_rng(seed).standard_normal((n, p))
    return G @ G.T / p + 1e-3 * np.eye(n)


def _spectrum(n, vals, seed):
    Q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, n)))
    A = (Q * vals[None, :]) @ Q.T
    return (A + A.T) / 2


def _matrices(n):
    """float64 cases: a Gram with a thin eps cluster (two levels of splits
    under MAX_BLOCK), a spectrum over six decades, and a Gram whose
    (n - p)-fold eps cluster spans the median."""
    return {"two_level_gram": _gram(n, 240, 11),
            "wide_spectrum": _spectrum(n, np.geomspace(1e-3, 1e3, n), 12),
            "cluster_median": _gram(n, 100, 13)}


def _scan_inputs():
    y, G, W, K = oracle.simulate(n=150, p=37, c=2, seed=41)
    G[:, 7] = 0.0  # a constant SNP: a NaN row
    return {"y": y, "G": G, "W": W, "K": K}


_RANK = r"""
import contextlib, datetime, functools, io, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[3])
import torch.distributed as dist
rank = int(os.environ["RANK"])
dist.init_process_group(
    "gloo", init_method="tcp://127.0.0.1:" + os.environ["MASTER_PORT"],
    rank=rank, world_size=%(world)d, timeout=datetime.timedelta(seconds=180))
import pygemma_tpu_torch as pt
from pygemma_tpu_torch.core import eigen, eigh_dc as tdc
from pygemma_tpu_torch.parallel.dist import sharded_eigh_fn
from pygemma_tpu_torch.parallel.mesh import make_mesh
d = dict(np.load(sys.argv[1]))
meshes = {name: make_mesh(snp=snp, sample=sample, device="cpu")
          for name, (sample, snp) in %(meshes)r.items()}
out = {}
sign_shapes = []  # (rows, cols) of every float64 sign iterate this rank held
real_step, real_ns = tdc._sign_step, tdc._sign_step_ns

def spy(fn):
    def step(X, *args):
        if X.dtype == torch.float64:
            sign_shapes.append(X.shape)
        return fn(X, *args)
    return step

tdc._sign_step, tdc._sign_step_ns = spy(real_step), spy(real_ns)

def eigh(case, mesh, A, max_block=%(max_block)d):
    print("@@case " + case, flush=True)
    eigen.eigh_dc = functools.partial(tdc.eigh_dc, max_block=max_block)
    ev, U = sharded_eigh_fn(meshes[mesh], pt.GwasConfig())(A)
    out[case + "|ev"], out[case + "|U"] = ev.numpy(), U.numpy()

os.environ["PYGEMMA_TPU_DC_VERBOSE"] = "1"
for key in [k for k in d if k.startswith("A|")]:
    _, name, n = key.split("|")
    for mesh in meshes if n == "301" else ("sample4",):
        eigh(f"{name}|{n}|{mesh}", mesh, d[key])
for mesh in meshes:
    eigh(f"float32|301|{mesh}", mesh, d["A|two_level_gram|301"].astype(
        np.float32))
out["sign_shapes"] = np.array(sign_shapes)
os.environ.pop("PYGEMMA_TPU_DC_VERBOSE")

# (b) pygemma on a 2 x 2 mesh, splits forced
eigen.eigh_dc = functools.partial(tdc.eigh_dc, max_block=%(scan_block)d)
built = []
real_fn = pt.api.sharded_eigh_fn
pt.api.sharded_eigh_fn = lambda *a: built.append(1) or real_fn(*a)
for dtype in ("float64", "float32"):
    df = pt.pygemma(d["y"], d["G"], d["W"], d["K"], device="cpu",
                    mesh=meshes["sample2_snp2"],
                    config=pt.GwasConfig(dtype=dtype, snp_block=16),
                    snps=[f"rs{i}" for i in range(d["G"].shape[1])])
    for col in df.columns:
        v = df[col].to_numpy()
        out[f"scan|{dtype}|{col}"] = v.astype(str) if v.dtype == object else v
out["scan_sharded_calls"] = np.array(len(built))

# (c) a split that fails
def failing(P, k, seed, refine=1, rows=None):
    return torch.full((P.shape[0], k), float("nan"), dtype=P.dtype)

tdc._orthonormal_range = failing
eigen.eigh_dc = functools.partial(tdc.eigh_dc, max_block=%(max_block)d)
os.environ["PYGEMMA_TPU_DC_VERBOSE"] = "1"
log = io.StringIO()
try:
    with contextlib.redirect_stdout(log):
        sharded_eigh_fn(meshes["sample2_snp2"], pt.GwasConfig())(
            d["A|two_level_gram|301"])
    out["failure"] = np.array("no error")
except RuntimeError as e:
    out["failure"] = np.array(str(e))
out["failure_log"] = np.array(log.getvalue())
np.savez(sys.argv[2], **out)
dist.destroy_process_group()
"""

_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, sys.argv[3])
import jax.numpy as jnp
import pygemma_tpu as pj
from pygemma_tpu.parallel.dist import sharded_eigh_fn
from pygemma_tpu.parallel.mesh import make_mesh
d = dict(np.load(sys.argv[1]))
out = {}
mesh = make_mesh(snp=2, sample=4)
fn = sharded_eigh_fn(mesh, pj.GwasConfig())
for key in [k for k in d if k.startswith("A|") and k.endswith("|300")]:
    with mesh:
        ev, _ = fn(jnp.asarray(d[key]))
    out[key[2:] + "|ev"] = np.asarray(ev)
for dtype in ("float64", "float32"):
    df = pj.pygemma(d["y"], d["G"], d["W"], d["K"],
                    mesh=make_mesh(snp=2, sample=2),
                    config=pj.GwasConfig(dtype=dtype, snp_block=16),
                    snps=[f"rs{i}" for i in range(d["G"].shape[1])])
    for col in df.columns:
        v = df[col].to_numpy()
        out[f"scan|{dtype}|{col}"] = v.astype(str) if v.dtype == object else v
np.savez(sys.argv[2], **out)
"""


def _inputs() -> dict:
    d = {f"A|{name}|{n}": A for n in (301, 300)
         for name, A in _matrices(n).items()}
    d.update(_scan_inputs())
    return d


def _splits(log: str) -> dict:
    """case -> sorted (n, depth, r_lo) of the split lines under its marker."""
    out, case = {}, None
    for line in log.splitlines():
        if line.startswith("@@case "):
            case = line.split(" ", 1)[1]
            out.setdefault(case, [])
            continue
        m = re.match(r"\[eigh_dc\] n=(\d+) depth=(\d+) split r_lo=(\d+)",
                     line)
        if m and case is not None:
            out[case].append(tuple(int(g) for g in m.groups()))
    return {k: sorted(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the split lines of every rank together, the
    JAX references)."""
    tmp = tmp_path_factory.mktemp("sharded_eigh")
    inp = str(tmp / "in.npz")
    np.savez(inp, **_inputs())
    fill = dict(world=WORLD, meshes=MESHES, max_block=MAX_BLOCK,
                scan_block=SCAN_BLOCK)
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(distributed._free_port()))
    env.pop("JAX_PLATFORMS", None)
    jax_out = str(tmp / "jax.npz")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX, inp, jax_out, ROOT], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    for rank in range(WORLD):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK % fill, inp,
             str(tmp / f"rank{rank}.npz"), ROOT],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=500)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, log) in enumerate(zip(procs, logs)):
        name = "jax" if i == 0 else f"rank {i - 1}"
        assert p.returncode == 0, f"{name} failed:\n{log[-4000:]}"
    splits = {}
    for log in logs[1:]:
        for case, lines in _splits(log).items():
            splits[case] = sorted(splits.get(case, []) + lines)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, splits, dict(np.load(jax_out))


def _one_process(A, max_block, capsys, monkeypatch):
    """The one-process eigh_dc of A and its split lines."""
    monkeypatch.setenv("PYGEMMA_TPU_DC_VERBOSE", "1")
    capsys.readouterr()
    ev, _ = tdc.eigh_dc(torch.as_tensor(A), max_block=max_block)
    return ev.numpy(), _splits("@@case one\n" + capsys.readouterr().out)[
        "one"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ["two_level_gram", "wide_spectrum",
                                  "cluster_median"])
def test_sharded_eigh_matches_one_process(runs, name, mesh, capsys,
                                          monkeypatch):
    """The same splits as the one-process eigh_dc (the root's and depth
    1's sharded), eigenvalues within 1e-10 of max|ev|, a float64
    certificate, and the same bytes on every rank."""
    ranks, splits, _ = runs
    case = f"{name}|301|{mesh}"
    A = _matrices(301)[name]
    ev1, split1 = _one_process(A, MAX_BLOCK, capsys, monkeypatch)
    assert splits[case] == split1
    assert (301, 0) in [s[:2] for s in split1]
    assert any(s[1] == 1 for s in split1)
    ev, U = ranks[0][case + "|ev"], ranks[0][case + "|U"]
    scale = np.abs(ev1).max()
    np.testing.assert_allclose(ev, np.maximum(ev1, 0.0), rtol=0,
                               atol=EV_TOL * scale)
    # tests/test_torch_eigh_dc.py's float64 certificate
    _check(A, ev, U, ev_tol=1e-9, resid_tol=1e-8, orth_tol=1e-10)
    for r in ranks[1:]:
        assert np.array_equal(r[case + "|ev"], ev)
        assert np.array_equal(r[case + "|U"], U)


@pytest.mark.parametrize("name", ["two_level_gram", "wide_spectrum",
                                  "cluster_median"])
def test_sharded_eigh_eigenvalues_match_jax(runs, name):
    """At n = 300 (the JAX package shards K's rows evenly) against the JAX
    package's sharded_eigh_fn on ``make_mesh(snp=2, sample=4)``."""
    ranks, _, ref = runs
    ev = ranks[0][f"{name}|300|sample4|ev"]
    want = ref[f"{name}|300|ev"]
    np.testing.assert_allclose(ev, want, rtol=0,
                               atol=EV_TOL * np.abs(want).max())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_eigh_float32_certificate(runs, mesh):
    """A float32 K: tests/test_eigh_dc.py's eigenvalue, residual and
    orthonormality tolerances; the same bytes on every rank."""
    ranks, _, _ = runs
    case = f"float32|301|{mesh}"
    A = _matrices(301)["two_level_gram"].astype(np.float32)
    ev, U = ranks[0][case + "|ev"], ranks[0][case + "|U"]
    assert ev.dtype == U.dtype == np.float32
    _check(A, ev, U)
    for r in ranks[1:]:
        assert np.array_equal(r[case + "|U"], U)


def test_no_rank_holds_a_whole_sign_iterate(runs):
    """Every float64 sign iterate at a sharded split is the rank's row slab:
    at n = 301, (76 or 75, 301) over four ranks or (151 or 150, 301) over
    two; no rank ever steps a whole 301 x 301 one."""
    ranks, _, _ = runs
    slabs = {hi - lo for s in (4, 2) for lo, hi in bounds(301, s)}
    for r in ranks:
        shapes = [tuple(s) for s in r["sign_shapes"]]
        assert (301, 301) not in shapes
        assert {rows for rows, cols in shapes if cols == 301} <= slabs
        assert any(cols == 301 for _, cols in shapes)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pygemma_sample_mesh_matches_jax_mesh_scan(runs, dtype):
    """``pygemma(..., mesh=make_mesh(snp=2, sample=2))`` with the
    eigendecomposition split over the sample ranks (max_block 48 at
    n = 150) against the JAX package's mesh scan; every rank's table is
    the same."""
    ranks, _, ref = runs
    assert all(int(r["scan_sharded_calls"]) == 2 for r in ranks)

    def table(d):
        prefix = f"scan|{dtype}|"
        return pd.DataFrame({k[len(prefix):]: v for k, v in d.items()
                             if k.startswith(prefix)})

    got = table(ranks[0])
    for r in ranks[1:]:
        other = table(r)
        for col in got.columns:
            np.testing.assert_array_equal(got[col].to_numpy(),
                                          other[col].to_numpy(), err_msg=col)
    _compare(got, table(ref), dtype)
    assert got.loc[got["SNPs"] == "rs7", "beta"].isna().all()


def test_failed_split_raises_on_every_rank(runs):
    """A split whose range find returns NaN raises eigh_dc's error on every
    rank of a 2 x 2 mesh, naming eigh_backend="host"; no rank hangs.  The
    root's coupling reads NaN on the group (a max all-reduce alone drops a
    NaN that only one rank holds) and both range attempts are refused."""
    ranks, _, _ = runs
    for r in ranks:
        msg = str(r["failure"])
        assert "coupling nan" in msg, msg
        assert 'eigh_backend="host"' in msg
    log = str(ranks[0]["failure_log"])
    assert log.count("n=301 depth=0 retry range (coupling nan)") == 2, log


@pytest.mark.parametrize("n,size", [(301, 4), (301, 2), (8, 8), (10, 3)])
def test_bounds_cover_the_rows(n, size):
    """The slabs tile [0, n) in order, the first n % size one row longer."""
    b = bounds(n, size)
    assert b[0][0] == 0 and b[-1][1] == n
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(b, b[1:]))
    rows = [hi - lo for lo, hi in b]
    assert rows == [n // size + (j < n % size) for j in range(size)]


def test_one_process_path_is_unchanged():
    """Without a group the routed helpers are the plain torch calls: a
    Newton-Schulz step and its residual give the same bytes as the
    products and reductions written out."""
    A = torch.as_tensor(_gram(96, 60, 3))
    S = tdc._shift_scale(A, 1.0, 5, 1.0)
    X2 = torch.matmul(S, S)
    got, resid = tdc._sign_step_ns(S, 1.5, -0.5)
    X2b = X2.clone()
    X2b.mul_(-0.5).diagonal().add_(1.5)
    assert torch.equal(got, torch.matmul(S, X2b))
    R = X2.abs()
    R.diagonal().copy_(X2.diagonal() - 1.0).abs_()
    assert torch.equal(resid, R.amax())
