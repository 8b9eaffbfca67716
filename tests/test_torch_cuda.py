"""Cases that need a CUDA card: the hand-written kernels against their plain
versions (K1 also at the implicit low-rank path's shape; the REML kernel in
every mode, with planted lanes, its launch count and a whole table; the
rotation kernel against float64 beside cuBLAS float32, its launches counted
on both scan paths and a whole table), the
pinned-buffer streamer for float, 2-bit and int8 genotypes, the device block
cache under a racing prefill, the scan on the card against the scan on the
CPU (one phenotype and the batched four), the kinship GEMM, the command
line, and the multi-GPU path: two ranks sharing the card over gloo, a
one-rank NCCL mesh, ``--mesh 2``, the kernel on a card that is not the
current one, and the trace spans' device clock against torch.profiler's.

The module imports neither jax nor pygemma_tpu, so on a machine with a card
it runs without the JAX-configuring conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

Without a card every case skips.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import oracle
import pygemma_tpu_torch as pt
from pygemma_tpu_torch.core import solver
from pygemma_tpu_torch.core.grams import (
    GramComplement,
    PackedGrams,
    grams_per_snp_lambda_fused_packed,
    grams_per_snp_lambda_packed,
    grams_shared_multi_packed,
    pair_products,
)
from pygemma_tpu_torch.io import streaming
from pygemma_tpu_torch.io.packed import PackedMatrix, write_rawbin_2bit
from pygemma_tpu_torch.io.quantized import MISSING_CODE, QuantizedMatrix
from pygemma_tpu_torch.io.streaming import SnpBlockStreamer
from pygemma_tpu_torch.ops import gram_kernel as gk
from pygemma_tpu_torch.ops import reml_kernel as rk
from pygemma_tpu_torch.ops import rotate_kernel as rot
from pygemma_tpu_torch.parallel import distributed

pytestmark = pytest.mark.gpu

FLOWS = {
    "lrt_score": {"tests": ("wald", "lrt", "score")},
    "de": {"de": True},
    "grid": {"grid": True},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data():
    y, G, W, K = oracle.simulate(n=220, p=40, c=3, seed=5)
    G[:, 7] = 0.0  # constant SNP: a full NaN row
    return y, G, W, K


def _kernel_inputs(n, B, c, R, device, lam_pows=(-4, 4)):
    rng = np.random.default_rng(n * 1000 + B)
    ev = np.abs(rng.normal(size=n)).astype(np.float32)
    ev[:20] *= 1e3  # a few large eigenvalues, as a kinship spectrum has
    shared = rng.normal(size=(n, c + 1)).astype(np.float32)
    X = rng.normal(size=(n, B)).astype(np.float32)
    size = B if R == 1 else (B, R)
    lam = np.power(10.0, rng.uniform(*lam_pows, size=size)).astype(np.float32)
    sh = torch.as_tensor(shared, device=device)
    return (torch.as_tensor(lam, device=device),
            torch.as_tensor(ev, device=device), pair_products(sh), sh,
            torch.as_tensor(X, device=device))


def _check_against_plain(args, kmax, want_logh):
    before = gk.fused_grams.launches
    got = gk.fused_grams(*args, kmax, want_logh)
    torch.cuda.synchronize()
    assert gk.fused_grams.launches == before + 1
    ref = gk.fused_grams_reference(*args, kmax, want_logh)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        b = b.cpu().numpy()
        # float32 sums in another order: the plain version's own rounding
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("c,R,kmax,want_logh", [
    (3, 1, 3, False), (3, 1, 1, True), (10, 2, 2, True), (1, 1, 3, True)])
def test_kernel_matches_plain(cuda, c, R, kmax, want_logh):
    # n = 4,099 is no whole number of 32-sample stages, B = 300 no whole
    # number of 128-column blocks (and not a multiple of 4: 4-byte copies)
    _check_against_plain(_kernel_inputs(4099, 300, c, R, cuda), kmax,
                         want_logh)


@pytest.mark.parametrize("n,B,c,R,kmax", [
    (4099, 17, 3, 1, 3), (4099, 17, 3, 3, 2), (4096, 256, 3, 1, 3),
    (4099, 300, 10, 2, 3)])
def test_kernel_ragged_and_wide(cuda, n, B, c, R, kmax):
    """Ragged columns (B = 17; R = 3 leaves the 16-byte copy path), whole
    tiles with 16-byte copies, and c = 10 with R = 2 at kmax 3: 11 feature
    tiles split over three blocks."""
    _check_against_plain(_kernel_inputs(n, B, c, R, cuda), kmax, True)


@pytest.mark.parametrize("pow_", [-5, 5])
def test_kernel_extreme_lambda(cuda, pow_):
    _check_against_plain(
        _kernel_inputs(4099, 300, 3, 1, cuda, lam_pows=(pow_, pow_)), 3, True)


@pytest.mark.parametrize("R,kmax,want_logh", [(1, 3, False), (2, 1, True)])
def test_kernel_at_the_implicit_shape(cuda, R, kmax, want_logh):
    """The implicit low-rank path's shape: p_k = 16,384 rows (splits capped
    at 1,024) and blocks of 8,192 SNPs."""
    _check_against_plain(_kernel_inputs(16_384, 8_192, 3, R, cuda), kmax,
                         want_logh)


def test_kernel_launches_are_bit_identical(cuda):
    args = _kernel_inputs(10_000, 2048, 3, 1, cuda)
    for kmax in (1, 3):
        a = gk.fused_grams(*args, kmax, True)
        b = gk.fused_grams(*args, kmax, True)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_streamer_blocks_match_the_host(cuda):
    X = np.random.default_rng(2).normal(size=(37, 23)).astype(np.float32)
    blocks = list(SnpBlockStreamer(X, 8, device=cuda))
    assert [(a, b) for a, b, _ in blocks] == [(0, 8), (8, 16), (16, 23)]
    for start, stop, xb in blocks:
        assert xb.is_cuda and xb.shape == (37, 8)
        host = xb.cpu().numpy()
        np.testing.assert_array_equal(host[:, :stop - start], X[:, start:stop])
        assert not host[:, stop - start:].any()


def _coded(kind, n=1001, p=300):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 3, size=(n, p)).astype(np.uint8)
    if kind == "int8":
        g = codes.astype(np.int8)
        g[1, 3] = g[7, 3] = MISSING_CODE
        return QuantizedMatrix.from_dosages(g)
    if kind == "bed":
        codes = np.array([0, 2, 3], np.uint8)[codes]
    codes[1, 3] = codes[7, 3] = 1 if kind == "bed" else 3
    return PackedMatrix.from_codes(codes, coding=kind)


@pytest.mark.parametrize("kind", ["dosage", "bed", "int8"])
def test_streamed_blocks_are_bit_exact(cuda, kind):
    """2-bit and int8 codes ship through the pinned ring and dequantize on
    the card: each block equals the host slice bit for bit."""
    X = _coded(kind)
    blocks = list(SnpBlockStreamer(X, 128, device=cuda))
    assert [(a, b) for a, b, _ in blocks] == [(0, 128), (128, 256),
                                             (256, 300)]
    for start, stop, xb in blocks:
        assert xb.is_cuda and xb.dtype == torch.float32
        np.testing.assert_array_equal(xb[:, :stop - start].cpu().numpy(),
                                      X[:, start:stop])


def test_block_cache_with_racing_prefill(cuda, tmp_path, monkeypatch):
    """Prefill threads racing the streamer on the card: every block lands in
    the cache once, the byte count equals the entries, and both the
    streamed and the cached blocks equal the host slices."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 3, size=(999, 640)).astype(np.uint8)
    Q0 = PackedMatrix.from_codes(codes)
    prefix = str(tmp_path / "c")
    write_rawbin_2bit(prefix, codes, Q0.mu, Q0.sd)
    X = PackedMatrix.open_rawbin(prefix)
    host = X[:, :]
    monkeypatch.setenv("PYGEMMA_TPU_GENO_DEV_CACHE_MB", "64")
    cache = streaming._DEV_BLOCK_CACHE
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        streaming.clear_device_block_cache()
        threads = [threading.Thread(
            target=streaming.prefill_device_cache, args=(X, 32),
            kwargs={"device": cuda}) for _ in range(4)]
        for t in threads:
            t.start()
        for _ in range(2):  # the first pass races, the second hits
            for start, stop, xb in SnpBlockStreamer(X, 32, device=cuda):
                np.testing.assert_array_equal(xb.cpu().numpy(),
                                              host[:, start:stop])
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert len(cache) == 20
        assert cache.nbytes == cache.entry_bytes() \
            == 20 * SnpBlockStreamer(X, 32).block_bytes
    finally:
        sys.setswitchinterval(old)
        streaming.clear_device_block_cache()


def _same_table(a, b, rtol=1e-6):
    """float64 card against float64 CPU: only the summation order
    differs."""
    assert list(a.columns) == list(b.columns)
    for col in b.columns:
        x, z = a[col].to_numpy(), b[col].to_numpy()
        if z.dtype.kind not in "fc":
            np.testing.assert_array_equal(x, z, err_msg=col)
            continue
        np.testing.assert_array_equal(np.isnan(x), np.isnan(z), err_msg=col)
        ok = ~np.isnan(z)
        np.testing.assert_allclose(x[ok], z[ok], rtol=rtol, atol=1e-12,
                                   err_msg=col)


def _close_p(a, b, col="p_wald"):
    """float32 tables, kernel on (card) against off (CPU): |d log10 p| <
    0.05, the JAX package's float32 contract."""
    p, q = a[col].to_numpy(), b[col].to_numpy()
    np.testing.assert_array_equal(np.isnan(p), np.isnan(q))
    ok = ~np.isnan(q)
    assert np.abs(np.log10(p[ok]) - np.log10(q[ok])).max() < 0.05


@pytest.mark.parametrize("flow", list(FLOWS))
def test_scan_float64_matches_cpu(data, cuda, flow):
    cfg = pt.GwasConfig(dtype="float64", snp_block=16)
    a = pt.pygemma(*data, config=cfg, device=cuda, **FLOWS[flow])
    b = pt.pygemma(*data, config=cfg, device="cpu", **FLOWS[flow])
    _same_table(a, b)


def _four_phenotypes(y):
    rng = np.random.default_rng(9)
    n = len(y)
    return np.c_[y, 0.5 * y + rng.standard_normal(n),
                 rng.standard_normal((n, 2))]


def test_batched_scan_float64_matches_cpu(data, cuda):
    """k = 4 takes the batched route on both devices."""
    y, G, W, K = data
    cfg = pt.GwasConfig(dtype="float64", snp_block=16,
                        tests=("wald", "lrt", "score"))
    Y = _four_phenotypes(y)
    _same_table(pt.pygemma(Y, G, W, K, config=cfg, device=cuda),
                pt.pygemma(Y, G, W, K, config=cfg, device="cpu"))


def test_batched_implicit_runs_the_kernel_per_phenotype(data, cuda):
    """The implicit path at k = 4 in float32: one top-space rotation a
    block for all four phenotypes, the kernel launched for each, and the
    table within the float32 contract of the CPU's."""
    from pygemma_tpu_torch import api

    y, G, W, _ = data
    lrk = pt.LowRankKinship(G[:, :24], eps=1e-3)
    cfg = pt.GwasConfig(snp_block=16)
    Y = _four_phenotypes(y)
    rot, k1 = api._rotate_top.count, gk.fused_grams.launches
    a = pt.pygemma(Y, G, W, lrk, config=cfg, device=cuda)
    blocks = -(-G.shape[1] // 16)
    assert api._rotate_top.count - rot == blocks
    # at least each phenotype's final Wald Grams in every block; the
    # solver's iterations add a data-dependent number
    assert gk.fused_grams.launches - k1 >= 4 * blocks
    _close_p(a, pt.pygemma(Y, G, W, lrk, config=cfg, device="cpu"))


@pytest.mark.parametrize("standardize", [False, True])
def test_kinship_on_the_card_matches_cpu(cuda, standardize):
    from pygemma_tpu_torch.io.kinship import kinship_blocked

    X = np.random.default_rng(8).normal(size=(300, 1000)).astype(np.float32)
    a = kinship_blocked(X, block=333, standardize=standardize, device=cuda)
    b = kinship_blocked(X, block=333, standardize=standardize, device="cpu")
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def test_cli_on_the_card(data, cuda, tmp_path):
    """python -m pygemma_tpu_torch run on the card (its default device)
    against the same command on the CPU."""
    import pandas as pd

    from pygemma_tpu_torch import __main__ as cli
    from pygemma_tpu_torch.io import bimbam, plink

    y, _, W, _ = data
    codes = np.random.default_rng(10).integers(0, 3, size=(len(y), 60))
    plink.write_bed(str(tmp_path / "g"), codes.astype(np.float32))
    bimbam.write_pheno(str(tmp_path / "y.txt"), y)
    args = ["run", "--bfile", str(tmp_path / "g"), "--pheno",
            str(tmp_path / "y.txt"), "--snp-block", "32", "--verbose", "0"]
    before = gk.fused_grams.launches
    cli.main(args + ["--out", str(tmp_path / "card.tsv")])
    assert gk.fused_grams.launches > before
    cli.main(args + ["--out", str(tmp_path / "cpu.tsv"), "--device", "cpu"])
    a, b = (pd.read_csv(tmp_path / f, sep="\t")
            for f in ("card.tsv", "cpu.tsv"))
    assert len(a) == 60
    _close_p(a, b)


def test_scan_float32_kernel_on_matches_off(data, cuda):
    """The main path through the kernel against the same path through its
    plain version, on the card."""
    cfg = pt.GwasConfig(snp_block=16)
    before = gk.fused_grams.launches
    on = pt.pygemma(*data, config=cfg, device=cuda)
    assert gk.fused_grams.launches > before
    off = pt.pygemma(*data, config=cfg.replace(use_fused_kernel=False),
                     device=cuda)
    p_on, p_off = on["p_wald"].to_numpy(), off["p_wald"].to_numpy()
    np.testing.assert_array_equal(np.isnan(p_on), np.isnan(p_off))
    ok = ~np.isnan(p_off)
    assert np.abs(np.log10(p_on[ok]) - np.log10(p_off[ok])).max() < 0.05


def _k1_kernels(prof):
    """(start, end) ns of each K1 launch in a torch.profiler trace: its
    partials kernel's start and its reduce kernel's end, in order."""
    from torch.autograd import DeviceType

    found = {name: [] for name in gk.KERNEL_NAMES}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        for name in gk.KERNEL_NAMES:
            if name in ev.name():
                found[name].append((ev.start_ns(),
                                    ev.start_ns() + ev.duration_ns()))
    parts, reduces = (sorted(found[name]) for name in gk.KERNEL_NAMES)
    assert len(parts) == len(reduces)
    return [(p[0], r[1]) for p, r in zip(parts, reduces)]


def test_spans_share_the_profiler_clock(cuda):
    """With markers on under torch.profiler, each ``k1`` span's device
    interval ends within 50 us of the profiler's K1 kernels and opens no
    later than 50 us after them (for 99% of the launches): spans and trace
    share one clock.  The span opens before the launch call, so on an idle
    card it also holds the launch's own latency.  The span counts match
    the program's counters."""
    from torch.profiler import ProfilerActivity, profile

    from pygemma_tpu_torch import api
    from pygemma_tpu_torch.utils import profiling

    y, G, W, K = oracle.simulate(n=2000, p=2048, c=3, seed=6)
    cfg = pt.GwasConfig(snp_block=256)
    pt.pygemma(y, G, W, K, config=cfg, device=cuda)  # warm: K1, the basis
    launches, rotations = gk.fused_grams.launches, api._rotate_top.count
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiling.enable()
        try:
            pt.pygemma(y, G, W, K, config=cfg, device=cuda)
            spans = profiling.collect()
        finally:
            profiling.disable()
    k1 = [s for s in spans if s.name == "k1"]
    assert len(k1) == gk.fused_grams.launches - launches > 0
    assert api._rotate_top.count == rotations  # a dense K: no top space
    blocks = {s.id for s in spans if s.name == "block"}
    assert len(blocks) == 2048 // 256
    assert sum(1 for s in spans
               if s.name == "rotate" and s.parent in blocks) == len(blocks)
    kernels = _k1_kernels(prof)
    assert len(kernels) == len(k1)
    d0 = np.array([s.device_start_ns - k[0] for s, k in zip(k1, kernels)])
    d1 = np.array([s.device_end_ns - k[1] for s, k in zip(k1, kernels)])
    print(f"k1 spans {len(k1)}, span minus kernel in us (p1, median, p99): "
          f"start {np.percentile(d0, [1, 50, 99]) / 1e3}, "
          f"end {np.percentile(d1, [1, 50, 99]) / 1e3}")
    assert np.mean((d0 <= 50_000) & (np.abs(d1) <= 50_000)) >= 0.99


_MESH_RANK = r"""
import json, sys
import numpy as np
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import oracle
import pygemma_tpu_torch as pt
from pygemma_tpu_torch.ops import gram_kernel as gk
from pygemma_tpu_torch.ops import reml_kernel as rk
from pygemma_tpu_torch.ops import rotate_kernel as rot
from pygemma_tpu_torch.parallel.distributed import all_sum
from pygemma_tpu_torch.parallel.mesh import make_mesh
y, G, W, K = oracle.simulate(n=220, p=40, c=3, seed=5)
G[:, 7] = 0.0
mesh = make_mesh(snp=int(sys.argv[4]))
out = {"backend": dist.get_backend()}
for dtype in ("float64", "float32"):
    cfg = pt.GwasConfig(dtype=dtype, snp_block=16, tests=("wald", "lrt"))
    before = gk.fused_grams.launches
    df = pt.pygemma(y, G, W, K, config=cfg, mesh=mesh)
    out[dtype] = df.to_dict(orient="list")
    out[dtype + "_launches"] = all_sum(gk.fused_grams.launches - before)
if dist.get_rank() == 0:
    with open(sys.argv[3], "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
"""


def _mesh_ranks(tmp_path, ranks):
    """Run _MESH_RANK as ``ranks`` processes (the launcher's environment)
    and return rank 0's tables."""
    import json

    import pandas as pd

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks),
               MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(distributed._free_port()))
    out = str(tmp_path / "mesh.json")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH_RANK, root, os.path.join(root, "tests"),
         out, str(ranks)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(ranks)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    with open(out) as f:
        res = json.load(f)
    tabs = {k: pd.DataFrame(res[k]).astype(float)
            for k in ("float64", "float32")}
    return res, tabs


@pytest.mark.parametrize("ranks,backend", [(2, "gloo"), (1, "nccl")])
def test_mesh_on_the_card_matches_one_process(data, cuda, tmp_path, ranks,
                                              backend):
    """Two ranks sharing the card (gloo: NCCL refuses two ranks on one
    device), and one rank alone (NCCL: device-tensor broadcasts and
    gathers), against the scan without a mesh: float64 to rtol 1e-6, float32
    within the float32 contract with the kernel launched."""
    res, tabs = _mesh_ranks(tmp_path, ranks)
    assert res["backend"] == backend
    for dtype, tab in tabs.items():
        cfg = pt.GwasConfig(dtype=dtype, snp_block=16, tests=("wald", "lrt"))
        ref = pt.pygemma(*data, config=cfg, device=cuda)
        if dtype == "float64":
            _same_table(tab, ref)
        else:
            _close_p(tab, ref)
            _close_p(tab, ref, "p_lrt")
            assert res["float32_launches"] > 0


def test_cli_mesh_on_the_card(data, cuda, tmp_path):
    """python -m pygemma_tpu_torch run --mesh 2: two ranks on the card,
    against the same command in one process."""
    import pandas as pd

    from pygemma_tpu_torch import __main__ as cli
    from pygemma_tpu_torch.io import bimbam, plink

    y = data[0]
    codes = np.random.default_rng(12).integers(0, 3, size=(len(y), 50))
    plink.write_bed(str(tmp_path / "g"), codes.astype(np.float32))
    bimbam.write_pheno(str(tmp_path / "y.txt"), y)
    args = ["run", "--bfile", str(tmp_path / "g"), "--pheno",
            str(tmp_path / "y.txt"), "--snp-block", "16", "--verbose", "0",
            "--tests", "wald,lrt,score"]
    cli.main(args + ["--out", str(tmp_path / "mesh.tsv"), "--mesh", "2"])
    cli.main(args + ["--out", str(tmp_path / "one.tsv")])
    a, b = (pd.read_csv(tmp_path / f, sep="\t")
            for f in ("mesh.tsv", "one.tsv"))
    assert len(a) == 50
    for col in ("p_wald", "p_lrt", "p_score"):
        _close_p(a, b, col)


def test_kernel_on_a_card_that_is_not_current(cuda):
    """The kernel launches on its tensors' card, not on the thread's
    current one (each rank of a multi-card host sets its own)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    torch.cuda.set_device(0)
    args = _kernel_inputs(4099, 300, 3, 1, torch.device("cuda", 1))
    _check_against_plain(args, 3, True)
    assert torch.cuda.current_device() == 0


# --- the REML kernel against its plain version --------------------------------
#
# Same packed Grams into both; values agree to 1e-5 of their scale (the
# kernel contracts multiply-adds into FMAs and sums in its own order, the
# plain version rounds each operation), decisions (bracket ends, stopped
# lanes, NaN rows, -inf) exactly.


def _reml_inputs(t, device, B=300, seed=0, dtype=np.float32):
    """(ev, shared, pairs, v, lam, comp) for Grams of size t: t - 1 shared
    columns, B SNPs, per-SNP lambdas over six decades, and an implicit
    complement whose residual Grams are those of 64 more samples."""
    rng = np.random.default_rng(1000 * t + seed)
    n, s = 700, t - 1
    ev = np.abs(rng.normal(size=n)) * 10.0 ** rng.uniform(-2, 2, size=n)
    shared = rng.normal(size=(n, s))
    X = rng.normal(size=(n, B))
    lam = 10.0 ** rng.uniform(-3, 3, size=B)
    Es, Ev = rng.normal(size=(64, s)), rng.normal(size=(64, B))
    def f(a):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    sh = f(shared)
    comp = GramComplement(f(1e-3), 64, f(Es.T @ Es), f(Ev.T @ Es),
                          f(np.sum(Ev * Ev, axis=0)))
    return f(ev), sh, pair_products(sh), f(X), f(lam), comp


def _reml_both(need, packed, lam, step=None, **kw):
    """Run the kernel and its plain version on copies of the step state:
    ((output, state) of the kernel, (output, state) of the plain one)."""
    res = []
    before = rk.reml_kernel.launches
    for fn in (rk.reml_kernel, solver.evaluate_plain):
        lam_c = lam.clone()
        st = None if step is None else type(step)(*(
            x.clone() if torch.is_tensor(x) else x for x in step))
        out = fn(need, packed, lam_c, step=st, **kw)
        res.append((out, (lam_c,) + (() if st is None else tuple(
            x for x in st if torch.is_tensor(x)))))
    torch.cuda.synchronize()
    assert rk.reml_kernel.launches == before + 1
    return res


def _agree(a, b, scale=None, what=""):
    """Same NaN / inf pattern, finite values within 1e-5 of |b| + scale."""
    a, b = (x.detach().cpu().double().numpy() for x in (a, b))
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    inf = np.isinf(b)
    np.testing.assert_array_equal(a[inf], b[inf], err_msg=what)
    ok = np.isfinite(b)
    tol = (1e-5 * (np.abs(b) + (0.0 if scale is None else scale))
           * np.ones_like(b))[ok]
    err = np.abs(a[ok] - b[ok])
    bad = ~(err <= tol)
    assert not bad.any(), (f"{what}: {bad.sum()} lanes, worst "
                           f"{np.max(err[bad] / tol[bad]):.2f}x tol")


def _agree_wald(a, b):
    """beta and |z| = sqrt(F) on the scale of the block's largest (beta and
    F near zero inherit x'P y's cancellation); se, tau, lambda relative."""
    for i, name in enumerate(("beta", "se", "tau", "lambda", "F")):
        x, y = (a[i], b[i]) if i < 4 else (a[i].sqrt(), b[i].sqrt())
        scale = None
        if i in (0, 4):
            scale = np.nanmax(np.abs(y.cpu().numpy()), initial=0.0)
        _agree(x, y, scale, f"wald {name}")


def _packed_k1(ev, sh, pairs, v, lam, kmax, want_logh):
    """K1's packed Grams, read in place; float64 (which K1 does not take)
    from the plain per-SNP builder."""
    ks = tuple(range(1, kmax + 1))
    if v.dtype == torch.float64:
        return grams_per_snp_lambda_packed(lam, ev, sh, pairs, v, v * v, ks,
                                           want_logh)
    return grams_per_snp_lambda_fused_packed(lam, ev, sh, pairs, v, ks,
                                             want_logh)


def _check_reml_modes(ev, sh, pairs, v, lam, comp, restricted, permute):
    """Every mode of the kernel against the plain version on K1's packed
    Grams (read in place) and on a lambda grid's."""
    n = int(ev.shape[0]) + (comp.n_comp if comp is not None else 0)
    q = sh.shape[1]
    kw = dict(n=n, q=q, permute=permute, restricted=restricted, comp=comp)
    lam_d = lam.double().cpu().numpy()
    scale1 = n / lam_d  # the size of d1's terms
    B = v.shape[1]
    # d1, the bisection step, d1 and d2, the Newton step
    p2 = _packed_k1(ev, sh, pairs, v, lam, 2, False)
    (a, _), (b, _) = _reml_both("d1", p2, lam, **kw)
    _agree(a, b, scale1, "d1")
    lo, hi = lam * 0.5, lam * 3.0
    flo = torch.where(torch.arange(B, device=lam.device) % 2 == 0, 1.0,
                      -1.0).to(lam.dtype)
    (_, sa), (_, sb) = _reml_both("d1", p2, lam,
                                  step=solver.Bisect(lo, hi, flo), **kw)
    _agree(sa[0], sb[0], None, "bisect midpoint")
    for x, y, name in zip(sa[1:], sb[1:], ("lo", "hi", "flo")):
        assert torch.equal(x, y), f"bisect {name}"
    p3 = _packed_k1(ev, sh, pairs, v, lam, 3, False)
    (a, _), (b, _) = _reml_both("newton", p3, lam, **kw)
    scale2 = scale1 / lam_d  # d2's terms: at small lambda they cancel
    _agree(a[0], b[0], scale1, "newton d1")
    _agree(a[1], b[1], scale2, "newton d2")
    done = torch.arange(B, device=lam.device) % 7 == 0
    newton = solver.Newton(lam * 0.2, lam * 5.0, done, 1e-5)
    (_, sa), (_, sb) = _reml_both("newton", p3, lam, step=newton, **kw)
    assert torch.equal(sa[3], sb[3]), "newton stops"
    # the step d1 / d2 carries d2's tolerance
    d1, d2 = (x.double().cpu().numpy() for x in b)
    _agree(sa[0], sb[0], np.abs(d1 / d2) * (1 + scale2 / np.abs(d2)),
           "newton iterate")
    # the likelihood, with and without a mask, and the Wald statistics
    p1 = _packed_k1(ev, sh, pairs, v, lam, 1, True)
    valid = torch.arange(B, device=lam.device) % 3 != 0
    for mask in (None, valid):
        (a, _), (b, _) = _reml_both("lik", p1, lam, valid=mask, **kw)
        _agree(a, b, None, "lik")
    p1w = _packed_k1(ev, sh, pairs, v, lam, 1, False)
    (a, _), (b, _) = _reml_both("wald", p1w, lam, **kw)
    assert torch.equal(a[1], b[1]), "wald x_ok"
    _agree_wald(a[0], b[0])
    # a shared lambda grid: (G, B) lanes
    grid = torch.tensor([10.0 ** k for k in range(-5, 6)], device=lam.device,
                        dtype=lam.dtype)
    for need, kmax in (("d1", 2), ("lik", 1)):
        pg = grams_shared_multi_packed(grid, ev, sh, pairs, v, v * v,
                                       tuple(range(1, kmax + 1)),
                                       need == "lik")
        (a, _), (b, _) = _reml_both(need, pg, grid, **kw)
        scale = (n / grid.double().cpu().numpy())[:, None] \
            if need == "d1" else None
        _agree(a, b, scale, f"grid {need}")


def _check_reml_all(ev, sh, pairs, v, lam, comp):
    for restricted in (True, False):
        for permute in (True, False):
            for cmp in (None, comp):
                _check_reml_modes(ev, sh, pairs, v, lam, cmp, restricted,
                                  permute)


@pytest.mark.parametrize("t", [*range(3, rk.T_MAX + 1), rk.T_MAX + 1, 24])
def test_reml_kernel_matches_plain(cuda, t):
    """Every mode, REML and ML, permuted (standard) and not (DE), with and
    without the implicit complement, for Grams of size 3 to T_MAX held in
    registers and two wider ones, whose build keeps its loops."""
    _check_reml_all(*_reml_inputs(t, cuda))


@pytest.mark.parametrize("t", [3, 5, rk.T_MAX, rk.T_MAX + 1])
def test_reml_kernel_matches_plain_float64(cuda, t):
    """The float64 build, which the port's float64 runs on the card take,
    in every mode as above."""
    _check_reml_all(*_reml_inputs(t, cuda, dtype=np.float64))


def _planted(packed, lane):
    """A copy of ``packed`` whose k = 1 Gram has y'y = -1 in ``lane``: the
    outcome's self term when the design is permuted (standard mode)."""
    S = packed.S.clone()
    s = packed.vS.shape[-1]
    yy = (s - 1) * s - (s - 1) * (s - 2) // 2  # triu index of (s-1, s-1)
    S[lane, 0, yy] = -1.0
    return PackedGrams(S, packed.vS, packed.vv, packed.sums)


@pytest.mark.parametrize("restricted", [True, False])
def test_reml_kernel_planted_lanes(cuda, restricted):
    """Planted lanes take the plain version's decisions.  Lane 0: a zero
    SNP, x'P x = 0: a full NaN Wald row.  Lane 1: a NaN SNP: NaN d1, Newton
    stops on the NaN guard.  Lane 2: y'P y < 0 with y'P^2 y > 0 at lambda
    = 1e4: the clamps give a finite d1 and d2 = +inf (y'P y clamped to
    MIN_VAL squares to 0), so d1 / d2 = -0 and Newton stops on the sign
    product, without a step.  Lane 3: a collapsed bracket: the step leaves
    it and Newton stops without updating."""
    ev, sh, pairs, v, lam, _ = _reml_inputs(5, cuda, B=64, seed=1)
    v = v.clone()
    v[:, 0] = 0.0
    v[:, 1] = float("nan")
    lam = lam.clone()
    lam[2] = 1e4
    n, q = int(ev.shape[0]), sh.shape[1]
    kw = dict(n=n, q=q, permute=True, restricted=restricted)
    B = v.shape[1]
    p3 = _planted(_packed_k1(ev, sh, pairs, v, lam, 3, False), 2)
    (a, _), (b, _) = _reml_both("newton", p3, lam, **kw)
    for x in (a, b):
        assert torch.isfinite(x[0][2]) and x[1][2] == float("inf")
    lo0, hi0 = lam * 0.2, lam * 5.0
    lo0[3] = hi0[3] = lam[3]
    done = torch.zeros(B, dtype=torch.bool, device=cuda)
    (_, sa), (_, sb) = _reml_both("newton", p3, lam,
                                  step=solver.Newton(lo0, hi0, done, 1e-5),
                                  **kw)
    assert torch.equal(sa[3], sb[3])
    _agree(sa[0], sb[0], None, "newton iterate")
    assert sb[3][1:4].all()
    assert torch.equal(sa[0][1:4], lam[1:4]) and torch.equal(sb[0][1:4],
                                                              lam[1:4])
    p2 = _planted(_packed_k1(ev, sh, pairs, v, lam, 2, False), 2)
    (a, _), (b, _) = _reml_both("d1", p2, lam, **kw)
    _agree(a, b, n / lam.double().cpu().numpy(), "d1")
    assert torch.isnan(a[1]) and torch.isnan(b[1])
    p1 = _planted(_packed_k1(ev, sh, pairs, v, lam, 1, True), 2)
    (a, _), (b, _) = _reml_both("lik", p1, lam, **kw)
    _agree(a, b, None, "lik")
    (a, _), (b, _) = _reml_both(
        "wald", _packed_k1(ev, sh, pairs, v, lam, 1, False), lam, **kw)
    assert torch.equal(a[1], b[1])
    assert not b[1][0] and not b[1][1] and b[1][2:].all()
    assert torch.isnan(a[0][:, :2]).all()
    _agree_wald(a[0], b[0])


def test_reml_kernel_launch_counts(data, cuda):
    """One launch per evaluation of the lambda search plus one Wald launch
    a block and phenotype, on the one-phenotype and the batched path, for
    Grams wider than T_MAX too, and in float64.  The ``lambda`` spans'
    kernel_evals count every evaluation."""
    from pygemma_tpu_torch.utils import profiling

    y, G, W, K = data
    cfg = pt.GwasConfig(snp_block=16, tests=("wald", "lrt"))
    blocks = -(-G.shape[1] // 16)
    for Y, k in ((y, 1), (_four_phenotypes(y), 4)):
        evals, launches = solver.evaluate.count, rk.reml_kernel.launches
        profiling.enable()
        try:
            pt.pygemma(Y, G, W, K, config=cfg, device=cuda)
            spans = profiling.collect()
        finally:
            profiling.disable()
        evals = solver.evaluate.count - evals
        assert rk.reml_kernel.launches - launches == evals + blocks * k
        lams = [s_ for s_ in spans if s_.name == "lambda"]
        assert sum(s_.attrs["kernel_evals"] for s_ in lams) == evals
    wide = np.c_[W, np.random.default_rng(3).normal(size=(len(y), 14))]
    assert wide.shape[1] + 1 > rk.T_MAX  # the null fit's Gram too
    for Wd, c in ((wide, cfg), (W, cfg.replace(dtype="float64"))):
        evals, launches = solver.evaluate.count, rk.reml_kernel.launches
        pt.pygemma(y, G, Wd, K, config=c, device=cuda)
        evals = solver.evaluate.count - evals
        assert rk.reml_kernel.launches - launches == evals + blocks


def test_reml_kernel_table_on_the_oracle_fixture(cuda):
    """n = 1,500: the table through the kernel within the float32 contract
    of the float64 oracle (|d log10 p| < 0.05) and of the same scan through
    the plain algebra on the card."""
    from pygemma_tpu_torch.core import assoc

    y, G, W, K = oracle.simulate(n=1500, p=512, c=3, seed=42)
    ev, U = np.linalg.eigh(K)
    ref = oracle.assoc_scan(np.maximum(ev, 0.0), U.T @ W, U.T @ y,
                            (U.T @ G)[:, :24])
    cfg = pt.GwasConfig(snp_block=256)
    launches = rk.reml_kernel.launches
    df = pt.pygemma(y, G, W, K, config=cfg, device=cuda)
    assert rk.reml_kernel.launches > launches
    p = df["p_wald"].to_numpy()
    assert np.abs(np.log10(p[:24]) - np.log10(ref["p_wald"])).max() < 0.05
    plain = lambda x: solver.evaluate_plain  # noqa: E731
    saved = solver.algebra, assoc.algebra
    solver.algebra = assoc.algebra = plain
    try:
        launches = rk.reml_kernel.launches
        off = pt.pygemma(y, G, W, K, config=cfg, device=cuda)
        assert rk.reml_kernel.launches == launches
    finally:
        solver.algebra, assoc.algebra = saved
    _close_p(df, off)


def _rotation_inputs(r, n, B, column_major, seed):
    """U' (r, n) with columns of norm ~1 and a standardized 2-bit-like block
    (n, B) on the card; U row-major (the implicit top space) or
    column-major (cuSOLVER's basis)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    U = (torch.randn(r, n, device="cuda", generator=g).T if column_major
         else torch.randn(n, r, device="cuda", generator=g)) / n ** 0.5
    p = torch.full((n, B), 0.3, device="cuda")
    codes = (torch.bernoulli(p, generator=g)
             + torch.bernoulli(p, generator=g))
    return U, ((codes - 0.6) / 0.648).contiguous()


@pytest.mark.parametrize("r,n,B,column_major", [
    (16_384, 50_000, 4_096, False),  # the implicit path's block
    (16_380, 50_000, 1_028, False),  # ... ragged, near a rank's quarter
    (10_000, 10_000, 2_048, True),   # the dense path's block
    (9_996, 10_000, 2_044, True),    # ... ragged
    (9_996, 10_000, 2_044, False),
    (1_028, 50_000, 516, True),      # cut down, the implicit path's K
    (1_028, 50_000, 516, False),
    # rows not a whole number of 16 bytes: U by cp.async, a block padded
    (9_999, 9_999, 2_049, True),     # a dense cohort of 9,999: both
    (10_001, 10_002, 2_048, True),   # U' rows of 10,002 floats
    (16_386, 50_000, 4_096, False),  # U rows of 16,386 floats
    (16_383, 50_001, 1_023, False),  # both, and an odd C row
])
def test_rotation_kernel_within_twice_cublas(cuda, r, n, B, column_major):
    """The kernel's largest error against the float64 product is at most
    twice that of cuBLAS's float32 torch.matmul at the same shape, whether
    TMA or cp.async reads U and whether the block is padded; its launches
    are bit-identical, and so are its results for either layout of the same
    U."""
    U, X = _rotation_inputs(r, n, B, column_major, seed=r + n + B)
    before = rot.rotate_kernel.launches
    got = rot.rotate(U, X)
    torch.cuda.synchronize()
    assert rot.rotate_kernel.launches == before + 1
    assert got.shape == (r, B) and got.dtype == torch.float32
    ref = torch.matmul(U.double().T, X.double())
    err = (got.double() - ref).abs().max().item()
    err_lib = (torch.matmul(U.T, X).double() - ref).abs().max().item()
    assert err <= 2.0 * err_lib, (err, err_lib)
    del ref
    assert torch.equal(got, rot.rotate_kernel(U, X))
    other = U.T.contiguous().T if not column_major else U.contiguous()
    assert torch.equal(got, rot.rotate_kernel(other, X))


@pytest.mark.parametrize("column_major", [False, True])
def test_rotation_kernel_reads_unaligned_starts(cuda, column_major):
    """U and the block starting one float past a 16-byte boundary (views
    into larger storage: U read by cp.async, the block padded) give, bit
    for bit, the product of aligned copies."""
    r, n, B = 1_028, 10_000, 516
    U, X = _rotation_inputs(r, n, B, column_major, seed=7)
    Us = torch.empty(r * n + 1, device="cuda")[1:]
    Us = (Us.view(r, n).T if column_major else Us.view(n, r))
    Us.copy_(U)
    Xs = torch.empty(n * B + 1, device="cuda")[1:].view(n, B)
    Xs.copy_(X)
    assert Us.data_ptr() % 16 and Xs.data_ptr() % 16
    assert not rot.u_by_tma(r, n, column_major, aligned=False)
    assert not rot.block_by_tma(B, aligned=False)
    want = rot.rotate_kernel(U, X)
    assert torch.equal(rot.rotate_kernel(Us, Xs), want)
    assert torch.equal(rot.rotate_kernel(Us, X), want)
    assert torch.equal(rot.rotate_kernel(U, Xs), want)


def test_rotation_launches_count_the_block_rotations(cuda):
    """On the card every block rotation is one launch and nothing else
    launches: the implicit scan's top-space rotations (``_rotate_top``) and
    one a block on the dense path; the rotations of W and y (c and 1
    columns) stay on torch.matmul."""
    from pygemma_tpu_torch import api

    y, G, W, K = oracle.simulate(n=221, p=300, c=3, seed=12)  # n % 4 = 1
    cfg = pt.GwasConfig(snp_block=128)
    blocks = -(-G.shape[1] // 128)
    lrk = pt.LowRankKinship(G[:, :24], eps=1e-3)
    launches, rotations = rot.rotate_kernel.launches, api._rotate_top.count
    pt.pygemma(y, G, W, lrk, config=cfg, device=cuda)
    assert api._rotate_top.count - rotations == blocks
    assert rot.rotate_kernel.launches - launches == blocks
    launches = rot.rotate_kernel.launches
    pt.pygemma(y, G, W, K, config=cfg, device=cuda)
    assert rot.rotate_kernel.launches - launches == blocks


@pytest.mark.parametrize("implicit", [False, True])
def test_scan_through_the_rotation_kernel_matches_cpu(cuda, implicit):
    """A float32 scan whose blocks go through the rotation kernel against
    the float64 scan on the CPU, within the float32 contract."""
    y, G, W, K = oracle.simulate(n=220, p=300, c=3, seed=13)
    G[:, 7] = 0.0  # constant SNP: a full NaN row
    kin = pt.LowRankKinship(G[:, 8:40], eps=1e-3) if implicit else K
    launches = rot.rotate_kernel.launches
    a = pt.pygemma(y, G, W, kin, config=pt.GwasConfig(snp_block=128),
                   device=cuda)
    assert rot.rotate_kernel.launches - launches == 3
    b = pt.pygemma(y, G, W, kin,
                   config=pt.GwasConfig(dtype="float64", snp_block=128),
                   device="cpu")
    _close_p(a, b)
