"""The port's multi-GPU path on the CPU: ``pygemma(..., mesh=)`` over a
2-rank gloo group of processes against the JAX package's mesh scan
(``pygemma_tpu.pygemma(..., mesh=)`` on 8 virtual CPU devices, as
tests/test_parallel.py runs it) on the same seeded numpy inputs.

One group of two ranks runs every case, and one child process runs every
JAX reference, both started once for the module and run side by side.
Each rank is a process started with the launcher's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), so ``make_mesh`` starts
the group from it.  Tolerances: float64, rtol 1e-6 on every statistic;
float32, the port's JAX tolerances (|d log10 p| < 0.05; the implicit path
also beta rtol 2e-3 and lambda rtol 5e-3).  Both ranks' tables are
identical.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import oracle
from pygemma_tpu_torch.io.quantized import MISSING_CODE
from pygemma_tpu_torch.parallel import distributed, mesh as tmesh
from test_torch_api import _compare
from test_torch_lowrank import _close_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS3 = ("wald", "lrt", "score")
#: case -> (genotypes, kinship, phenotypes, covariates, config fields,
#: pygemma keywords, mesh).  p = 37 SNPs is no multiple of the block or of
#: the two ranks; with snp_block 15 the block rounds up to 16.
CASES = {
    "dense_wald": ("G", "K", "y", "W", {}, {}, "snp2"),
    "dense_lrt_score": ("G", "K", "y", "W", {"tests": TESTS3}, {}, "snp2"),
    "eigen_false": ("Gr", "ev", "yr", "Wr", {}, {"eigen": False}, "snp2"),
    "de": ("G", "K", "y", "W", {}, {"de": True}, "snp2"),
    "packed_implicit": ("packed", "lowrank", "y", "W",
                        {"tests": TESTS3, "dtype": "float32"}, {}, "snp2"),
    "quantized": ("int8", "K", "y", "W", {"dtype": "float32"}, {}, "snp2"),
    "ragged_block": ("G", "K", "y", "W", {"snp_block": 15}, {}, "snp2"),
    "k4": ("G", "K", "Y4", "W", {"tests": TESTS3}, {}, "snp2"),
    "sample2": ("G", "K", "y", "W", {}, {}, "sample2"),
    "run_dir": ("G", "K", "y", "W", {"tests": TESTS3}, {}, "snp2"),
}

#: builds one case's pygemma arguments from the inputs; shared by both
#: children (``pkg`` is pygemma_tpu or pygemma_tpu_torch)
_BUILD = r"""
def build(pkg, packed_cls, quant_cls, d, case):
    xk, kk, yk, wk, fields, kw, _ = CASES[case]
    fields = dict(fields)
    fields.setdefault("dtype", "float64")
    fields.setdefault("snp_block", 16)
    X = {"packed": lambda: packed_cls.from_codes(d["codes"]),
         "int8": lambda: quant_cls.from_dosages(d["codes_i8"])}.get(
             xk, lambda: d[xk])()
    K = (pkg.LowRankKinship(d["G_k"], eps=1e-3) if kk == "lowrank"
         else d[kk])
    return (d[yk], X, d[wk], K), dict(kw), pkg.GwasConfig(**fields)
"""

_RANK = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[3])
import torch.distributed as dist
import pygemma_tpu_torch as pt
from pygemma_tpu_torch.io.packed import PackedMatrix
from pygemma_tpu_torch.io.quantized import QuantizedMatrix
from pygemma_tpu_torch.parallel.mesh import make_mesh
CASES = %(cases)r
%(build)s
d = dict(np.load(sys.argv[1]))
rank = int(os.environ["RANK"])
work = sys.argv[4]
meshes = {"snp2": make_mesh(snp=2, device="cpu"),
          "sample2": make_mesh(snp=1, sample=2, device="cpu")}
out = {}

def keep(name, df):
    for col in df.columns:
        v = df[col].to_numpy()
        out[f"{name}|{col}"] = v.astype(str) if v.dtype == object else v

def drop_last_block(run_dir):
    # rank 0 removes the last finished block, as a preempted run leaves it
    if rank == 0:
        last = sorted(f for f in os.listdir(run_dir) if f.startswith("block_"))
        os.remove(os.path.join(run_dir, last[-1]))
    dist.barrier()

for case in CASES:
    args, kw, cfg = build(pt, PackedMatrix, QuantizedMatrix, d, case)
    mesh = meshes[CASES[case][-1]]
    names = [f"rs{i}" for i in range(args[1].shape[1])]
    if case != "run_dir":
        keep(case, pt.pygemma(*args, config=cfg, mesh=mesh, device="cpu",
                              snps=names, **kw))
        continue
    # a mesh run, then the same run resumed from its own run_dir
    rd = os.path.join(work, "rd_mesh")
    kw.update(snps=names, device="cpu")
    keep("run_dir_first", pt.pygemma(*args, config=cfg, mesh=mesh,
                                     run_dir=rd, **kw))
    drop_last_block(rd)
    keep(case, pt.pygemma(*args, config=cfg, mesh=mesh, run_dir=rd, **kw))
    # a single-rank run_dir (rank 0 alone), resumed by a mesh run
    rd1 = os.path.join(work, "rd_single")
    if rank == 0:
        keep("run_dir_single", pt.pygemma(*args, config=cfg, run_dir=rd1,
                                          **kw))
    dist.barrier()
    drop_last_block(rd1)
    keep("run_dir_from_single", pt.pygemma(*args, config=cfg, mesh=mesh,
                                           run_dir=rd1, **kw))
np.savez(sys.argv[2], **out)
"""

_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, sys.argv[3])
import pygemma_tpu as pj
from pygemma_tpu.io.packed import PackedMatrix
from pygemma_tpu.io.quantized import QuantizedMatrix
from pygemma_tpu.parallel.mesh import make_mesh
CASES = %(cases)r
%(build)s
d = dict(np.load(sys.argv[1]))
meshes = {"snp2": make_mesh(snp=2), "sample2": make_mesh(snp=2, sample=2)}
out = {}
for case in CASES:
    args, kw, cfg = build(pj, PackedMatrix, QuantizedMatrix, d, case)
    if case == "run_dir":
        kw["run_dir"] = os.path.join(sys.argv[4], "rd_jax")
    df = pj.pygemma(*args, config=cfg, mesh=meshes[CASES[case][-1]],
                    snps=[f"rs{i}" for i in range(args[1].shape[1])], **kw)
    for col in df.columns:
        v = df[col].to_numpy()
        out[f"{case}|{col}"] = v.astype(str) if v.dtype == object else v
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def inputs():
    """oracle.simulate (n = 64, p = 37, c = 2) with a constant SNP and four
    phenotypes; the same rotated by K's eigenbasis; 2-bit codes with 3%
    missing and their int8 dosages; a 24-SNP kinship for the implicit
    low-rank K."""
    rng = np.random.default_rng(71)
    y, G, W, K = oracle.simulate(n=64, p=37, c=2, seed=29)
    G[:, 7] = 0.0
    n = len(y)
    ev, U = np.linalg.eigh(K)
    codes = rng.integers(0, 3, size=(n, 37)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.03] = 3
    G_k = rng.binomial(2, 0.3, size=(n, 24)).astype(np.float32)
    G_k = (G_k - G_k.mean(0)) / np.maximum(G_k.std(0), 1e-6)
    return {"y": y, "G": G, "W": W, "K": K,
            "Y4": np.c_[y, 0.5 * y + rng.standard_normal(n),
                        rng.standard_normal((n, 2))],
            "ev": np.maximum(ev, 0.0), "yr": U.T @ y, "Gr": U.T @ G,
            "Wr": U.T @ W, "codes": codes,
            "codes_i8": np.where(codes == 3, MISSING_CODE, codes).astype(
                np.int8),
            "G_k": G_k}


def _read(path) -> dict:
    """npz of "case|column" arrays -> case -> DataFrame."""
    z = dict(np.load(path))
    cases = {}
    for key, v in z.items():
        case, col = key.split("|")
        cases.setdefault(case, {})[col] = v
    return {case: pd.DataFrame(cols) for case, cols in cases.items()}


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """(rank 0's tables, rank 1's, the JAX package's): the two ranks and the
    JAX child run at the same time."""
    tmp = tmp_path_factory.mktemp("parallel")
    inp = str(tmp / "in.npz")
    np.savez(inp, **inputs)
    fill = {"cases": CASES, "build": _BUILD}
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(distributed._free_port()))
    env.pop("JAX_PLATFORMS", None)
    jax_out = str(tmp / "jax.npz")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX % fill, inp, jax_out, ROOT, str(tmp)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)]
    for rank in (0, 1):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK % fill, inp,
             str(tmp / f"rank{rank}.npz"), ROOT, str(tmp)],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for name, p, log in zip(("jax", "rank 0", "rank 1"), procs, logs):
        assert p.returncode == 0, f"{name} failed:\n{log[-4000:]}"
    return (_read(tmp / "rank0.npz"), _read(tmp / "rank1.npz"),
            _read(jax_out))


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_table_matches_jax_mesh_scan(runs, case):
    rank0, rank1, ref = runs
    got = rank0[case]
    # every rank returns the identical table
    assert list(got.columns) == list(rank1[case].columns)
    for col in got.columns:
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      rank1[case][col].to_numpy(), err_msg=col)
    fields = CASES[case][4]
    if fields.get("dtype") == "float32":
        if CASES[case][1] == "lowrank":
            assert list(got.columns) == list(ref[case].columns)
            _close_stats(got, ref[case], cols=("p_wald", "p_lrt", "p_score"))
        else:
            _compare(got, ref[case], "float32")
    else:
        _compare(got, ref[case], "float64")
    n_pheno = 4 if case == "k4" else 1
    assert len(got) == 37 * n_pheno
    if case not in ("de", "packed_implicit", "quantized"):
        # the constant SNP is a NaN row in every phenotype
        assert got.loc[got["SNPs"] == "rs7", "beta"].isna().all()


def test_mesh_run_dir_resumes(runs):
    """A mesh run resumes from its own run_dir and from a single-rank one:
    the tables equal the uninterrupted runs'."""
    rank0, rank1, _ = runs
    for name, ref in (("run_dir", "run_dir_first"),
                      ("run_dir_from_single", "run_dir_single")):
        _compare(rank0[name], rank0[ref], "float64")
        _compare(rank1[name], rank0[ref], "float64")


@pytest.mark.parametrize("env,expect", [
    ({"WORLD_SIZE": "3", "RANK": "2", "LOCAL_RANK": "0"}, (3, 2, 0)),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "3", "SLURM_LOCALID": "1"},
     (4, 3, 1)),
    ({"SLURM_NTASKS": "8", "SLURM_PROCID": "5"}, (8, 5, 5)),
    ({}, (1, 0, 0)),
])
def test_initialize_reads_the_launcher_environment(monkeypatch, env, expect):
    """torchrun's names first, SLURM's as fallbacks; the group is started
    with what they say (the call itself is recorded, not made)."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID",
              "SLURM_NTASKS_PER_NODE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if expect[0] > 1:
        monkeypatch.setenv("MASTER_PORT", "29512")
    seen = {}

    def fake_init(backend, **kw):
        seen.update(kw, backend=backend)

    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.dist, "init_process_group", fake_init)
    assert distributed.initialize(device="cpu") == torch.device("cpu")
    assert (seen["world_size"], seen["rank"]) == expect[:2]
    assert seen["backend"] == "gloo"
    if expect[0] > 1:
        assert seen["init_method"] == "tcp://127.0.0.1:29512"
    else:
        assert "store" in seen


def test_initialize_needs_a_meeting_point(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_PORT", raising=False)
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        distributed.initialize(device="cpu")


@pytest.mark.parametrize("local_world,cards,want", [
    (1, 1, "nccl"), (2, 1, "gloo"), (4, 4, "nccl"), (8, 4, "gloo")])
def test_auto_backend(monkeypatch, local_world, cards, want):
    """NCCL when every rank of a host has a card of its own, else gloo; the
    CPU is always gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert distributed.resolve_backend(torch.device("cuda", 0),
                                       local_world) == want
    assert distributed.resolve_backend(torch.device("cpu"),
                                       local_world) == "gloo"


@pytest.mark.parametrize("start,stop,block,shard,want", [
    (0, 16, 16, (0, 2), (0, 8)), (0, 16, 16, (1, 2), (8, 16)),
    (32, 37, 16, (0, 2), (32, 37)), (32, 37, 16, (1, 2), (37, 37)),
    (16, 32, 16, (3, 4), (28, 32)), (0, 5, 8, (0, 1), (0, 5)),
])
def test_local_columns(start, stop, block, shard, want):
    """A rank's share of a block, cut at the block's end (empty past it)."""
    assert tmesh.local_columns(start, stop, block, shard) == want


def test_sharded_streamer_reads_only_its_columns():
    """Two shards of every block put together give the whole matrix, and
    each shard's codes are the only ones read."""
    from pygemma_tpu_torch.io.packed import PackedMatrix
    from pygemma_tpu_torch.io.streaming import SnpBlockStreamer

    codes = np.random.default_rng(3).integers(0, 3, size=(30, 37)).astype(
        np.uint8)
    X = PackedMatrix.from_codes(codes)
    reads = []
    real = X.quant_block

    def counted(start, stop):
        reads.append((start, stop))
        return real(start, stop)

    X.quant_block = counted
    parts = [list(SnpBlockStreamer(X, 16, device="cpu", shard=(j, 2)))
             for j in range(2)]
    got = np.concatenate([np.concatenate([a[2].numpy(), b[2].numpy()], 1)
                          for a, b in zip(*parts)], 1)[:, :37]
    np.testing.assert_array_equal(got, X[:, :])
    assert sorted(reads) == [(0, 8), (8, 16), (16, 24), (24, 32), (32, 37)]
    assert all(xb.shape == (30, 8) for part in parts for _, _, xb in part)
    with pytest.raises(ValueError, match="equal shares"):
        SnpBlockStreamer(X, 15, device="cpu", shard=(0, 2))
