#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``pygemma_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. environment: torch/CUDA versions, the card's name and power limit, and
   the full-float32 matmul settings the scan requires;
2. build: the hand-written kernel (``csrc/gram_kernel.cu``) with nvcc and
   the host .bed decoder (``native/bed_reader.cpp``) with g++, at once;
3. kernel parity: ``fused_grams`` through the kernel against its plain
   PyTorch version on the card at the main path's shapes; then the REML
   kernel (``csrc/reml_kernel.cu``) against its plain version in every
   mode (d1 over a lambda grid, bisection, Newton, likelihood, Wald) at
   the dense scan's shape (n = 10,000, blocks of 2,048) and the implicit
   one (a top space of 16,384 with the complement, blocks of 4,096), held
   to the gpu tests' 1e-5-of-scale rule with every decision equal;
4. small end to end: the port's ``pygemma`` on the card in float32 against
   the float64 NumPy oracle (tests/oracle.py), and in float64 against the
   port on the CPU;
5. the large-GWAS path (``bench.py``'s large configuration): a 2-bit
   cohort of n = 20,000 samples x p = 100,000 SNPs drawn on the card and
   written to a temporary directory (~500 MB), streamed through
   ``PackedMatrix.open_rawbin`` with K the GRM of its first 16,384 SNPs
   plus 1e-3 I as an implicit ``LowRankKinship``, blocks of 8,192 SNPs,
   ``run_dir`` checkpointing: the top basis timed alone, the scan cold and
   warm with the kernel's launches and host syncs counted, checks on the
   first block (device dequant against the host slice, float32 input,
   both kernels off, the explicit full basis), the device block cache with and
   without the prefill thread, and a PLINK .bed slice against the same
   codes in the dosage coding;
6. full width, dense K: n = 10,000 samples, p = 50,000 SNPs, c = 3, REML
   Wald, with the kernel's launches and the solver's host syncs counted
   over the run, then the first block again with the kernel off, and a
   torch.profiler breakdown of four warm blocks (device busy time, time by
   kernel);
7. kernel times at both paths' shapes: the kernel's device time per call
   (torch.profiler), its wall time per call and the plain version's wall
   time; the same for the REML kernel in each mode of phase 3's cases; the
   rotation kernel at the benchmark's three block shapes (CUDA events),
   beside its bound and torch.matmul's time, its error against float64
   held to at most twice cuBLAS float32's.
   Phases 5, 6, 9 and 10 time their scans before any profiler runs,
   because the profiler, once run, slows every later launch from the host;
8. one JSON line of the kernels, K1, the REML kernel and the rotation
   kernel, each with its launches by path (phase 12a's scan is one of
   them; every path counts the REML kernel's launches against the search's
   evaluations, and every in-process path the rotation kernel's against its
   block rotations: all of them, and nothing else), and a last line
   ``{"ok": true, "device": {...}}``;
9. (run right after phase 5, on its cohort) the batched multi-phenotype
   scan, bench.py:401-423: y and three more phenotypes built as there, one
   block to warm, then all four over p = 100,000 in one call, with the
   kernel's launches, the top-space rotations, host syncs and peak device
   memory counted; its phenotype-0 rows held to phase 5's table, and its
   first block to the looped scan of the same four phenotypes (forced by
   run_dir);
10. (then) the command line on a PLINK cohort of n = 10,000 x p = 50,000
   written from codes drawn and packed on the card: ``python -m
   pygemma_tpu_torch run`` as a subprocess, the GRM built on the card by
   ``kinship_blocked``, four phenotypes to a TSV, then phenotype 0 with
   Wald/LRT/score to GEMMA's .assoc.txt; the native .bed decode against
   NumPy's, the GRM against float64 NumPy, and both runs' tables, with
   each stage's time from the CLI's stage log;
11. multi-rank (``parallel/``): (a) phase 5's configuration over a mesh of
   two ranks, processes sharing the one card over gloo, each with a
   warm-up call then a timed one, the ranks' tables held identical and to
   phase 5's within the float32 contract, with the basis on rank 0, its
   broadcast, the slower rank's warm scan, K1's launches summed over the
   ranks and each rank's peak memory; (b) the command line with ``--mesh
   2`` and phase 10's run-2 arguments, held to run 2's table; (c) run last,
   a one-rank NCCL mesh in this process (device-tensor broadcasts and
   gathers) on a float64 dense fixture, held to the scan without a mesh
   at rtol 1e-6;
12. the spectral divide-and-conquer eigh (``core/eigh_dc.py``) with its
   per-split lines on: (a) after phase 11, in phase 5's cohort,
   ``lowrank_top_basis(lrk, "dc")`` on the 16,384 x 16,384 Gram, timed
   against phase 5's cuSOLVER basis, its eigenvalues held to cuSOLVER's and
   its certificate (per-pair residuals, orthonormality) to
   tests/test_eigh_dc.py's tolerances, the depth-0 split's sign steps,
   polish rounds and range retries read from its lines, its peak device
   memory; then the cohort scanned on the dc basis (a cold call, then the
   path's warm run with the kernel's launches counted) and held to phase
   5's table within the implicit-basis contract; (b) after phase 6's timed
   scan, ``auto_eigendecompose(K, "dc")`` on its dense n = 10,000 K (the
   edge-shave split), held to cuSOLVER's eigenvalues;
14. (after phase 6) the sample-sharded eigendecomposition: two ranks
   sharing the card over gloo on ``make_mesh(snp=1, sample=2)``, one group
   for both parts: (a) phase 6's dense configuration through ``pygemma(...,
   mesh=)``, eigh_dc's products split over the two ranks (the root's edge
   shave; one leaf a rank), its eigenvalues held to cuSOLVER's and its
   certificate as in phase 12, both ranks' tables identical and held to
   phase 6's, the eigh's seconds, each rank's peak memory and bytes sent,
   K1's launches summed over the ranks; (b) phase 12a's 16,384 Gram through
   ``sharded_eigh_fn``, held the same way, both ranks' bytes identical;
13. (last) the workload layer in this process: each
   ``experiments/*/*_torch.py`` script's ``main()`` at its defaults
   (large_gwas on pre-rotated rawbins of a 2,000 x 8,192 fixture) and the
   five scenarios of ``configs/run_config_torch.py`` at the scales of
   ``configs/run_config.py``'s docstring, each timed, its tables checked
   for finite p-values.

It exits non-zero without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# main-path shape of the kernel: one SNP block of the full-width run
N_FULL, P_FULL, C_FULL, BLOCK = 10_000, 50_000, 3, 2_048
PROFILE_BLOCKS = 4  # warm blocks traced by torch.profiler
PROFILE_BLOCKS_LARGE = 2  # ... on the large-GWAS path
# the large-GWAS path (bench.py:9-18, :210-252): 2-bit cohort, implicit
# low-rank kinship of the first PK_LARGE SNPs, blocks of BLOCK_LARGE
N_LARGE, P_LARGE, C_LARGE = 20_000, 100_000, 3
PK_LARGE, BLOCK_LARGE, EPS_LARGE = 16_384, 8_192, 1e-3
BED_SNPS = 2_048  # the .bed coding check's slice
# implicit vs explicit basis: tests/test_lowrank.py's tolerances
LOWRANK_DLOGP, LOWRANK_BETA_RTOL, LOWRANK_BETA_ATOL = 0.05, 2e-3, 1e-5
LOWRANK_LAM_RTOL = 5e-3
PARITY_RTOL = PARITY_ATOL = 1e-4  # beyond the float32 plain version's error
SMALL_DLOGP = 0.05  # the JAX package's float32 contract vs the oracle
CARD_CPU_RTOL = 1e-6  # float64 card vs float64 CPU
OFF_DLOGP, OFF_BETA_RTOL = 0.05, 5e-3  # kernel on vs off at full width
K_PHENOS = 4  # bench.py's multi-phenotype step (PYGEMMA_BENCH_PHENOS)
# phase 7: the rotation kernel's block shapes (r, n, B, U column-major):
# the implicit scan's (one card, and a quarter block a rank on four) and
# the dense scan's
ROTATE_SHAPES = ((16_384, 50_000, 4_096, False), (16_384, 50_000, 1_024, False),
                 (N_FULL, N_FULL, BLOCK, True))
GRM_CHECK, GRM_RTOL = 512, 1e-5  # K[:512, :512] against float64 NumPy
CLI_TIMEOUT = 900  # seconds for one CLI subprocess
MESH_RANKS = 2  # phase 11: ranks sharing the one card
MESH_DLOGP = 0.05  # the float32 contract between a mesh and one process
# phase 11c: the one-rank NCCL mesh's float64 dense fixture
NCCL_N, NCCL_P, NCCL_BLOCK = 1_500, 4_096, 2_048
# phase 12: eigh_dc against cuSOLVER, tests/test_eigh_dc.py's tolerances
DC_EV_RTOL, DC_EV_ATOL = 5e-4, 2e-4  # the atol times max|ev|
DC_RESID, DC_ORTH = 5e-4, 1e-3  # residual times max|ev|; max |U'U - I|
SHARD_RANKS = 2  # phase 14: sample ranks sharing the one card
# phase 13: large_gwas's pre-rotated fixture, and the scenarios' scales
# (configs/run_config.py's docstring)
LG_N, LG_P = 2_000, 8_192
SCENARIO_SCALES = {"mouse_hs1940": 1.0, "bxd": 1.0, "gd449_multi": 1.0,
                   "ukb_synth": 0.1, "large_gwas_sharded": 1.0}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def reml_launches(solver, wald_steps, label):
    """The REML kernel's launches and the lambda search's evaluations since
    both counters were set to 0, checked: every evaluation launched the
    kernel once, and so did each of ``wald_steps`` Wald steps (blocks x
    phenotypes; None where a phase cannot count them)."""
    from pygemma_tpu_torch.ops import reml_kernel as rk

    launches, evals = rk.reml_kernel.launches, solver.evaluate.count
    check(evals > 0 and launches >= evals,
          f"{label}: {launches} REML kernel launches for {evals} "
          "evaluations")
    if wald_steps is not None:
        check(launches == evals + wald_steps,
              f"{label}: {launches} REML kernel launches for {evals} "
              f"evaluations and {wald_steps} Wald steps")
    return launches, evals


def reset_launches(gk, solver):
    """Set K1's, the REML kernel's and the rotation kernel's launch
    counters, the search's evaluation counter and the top-space rotation
    counter to 0."""
    from pygemma_tpu_torch import api
    from pygemma_tpu_torch.ops import reml_kernel as rk
    from pygemma_tpu_torch.ops import rotate_kernel as rot

    gk.fused_grams.launches = 0
    rk.reml_kernel.launches = 0
    rot.rotate_kernel.launches = 0
    solver.evaluate.count = 0
    api._rotate_top.count = 0


def rotate_launches(rotations, label):
    """The rotation kernel's launches since :func:`reset_launches`, checked
    against the path's block rotations: each went through the kernel, and
    nothing else launched it."""
    from pygemma_tpu_torch.ops import rotate_kernel as rot

    launches = rot.rotate_kernel.launches
    check(launches == rotations > 0,
          f"{label}: {launches} rotation kernel launches for {rotations} "
          "block rotations")
    return launches


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call on the card: CUDA events around ``reps``
    back-to-back calls, after a warm-up.  Where the host enqueues slower
    than the card runs, this holds the host's gaps too: it is a wall time,
    and :func:`device_ms` gives a kernel's own time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, names, reps: int = 30) -> float:
    """Device milliseconds per call: for each kernel whose name contains
    one of ``names``, its mean device duration under torch.profiler over
    ``reps`` calls after a warm-up, summed over the kernels.  Host gaps
    between launches are not in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = 0.0
    for name in names:
        us = [e.time_range.elapsed_us() for e in dev if name in e.name]
        # the profiler may drop events (seen: up to half of a window's);
        # the mean over those it kept is still the time of one launch
        check(len(us) >= 5,
              f"profiler saw {len(us)} launches of {name} in {reps} calls")
        total += sum(us) / len(us) / 1e3
    return total


def kernel_inputs(n, B, c, R, gen):
    import torch

    from pygemma_tpu_torch.core.grams import pair_products

    dev = "cuda"
    ev = torch.rand(n, device=dev, generator=gen) * 5.0
    shared = torch.randn(n, c + 1, device=dev, generator=gen)
    v = torch.randn(n, B, device=dev, generator=gen)
    lam = 10.0 ** (torch.rand(B, R, device=dev, generator=gen) * 8.0 - 4.0)
    return (lam[:, 0] if R == 1 else lam), ev, pair_products(shared), shared, v


def parity(gk, got, args, kmax, logh):
    """``got``, a fused_grams result on ``args``, against float64.  The
    rule: its error may exceed the float32 plain version's by
    PARITY_RTOL * |ref| + PARITY_ATOL * max|ref|.  Returns (whether every
    output meets it, max |got - plain float32|, max over the outputs of
    max |got - float64| / max |float64|, the same for the plain
    version)."""
    import torch

    plain = gk.fused_grams_reference(*args, kmax, logh)
    ref64 = gk.fused_grams_reference(*args, kmax, logh, dtype=torch.float64)
    ok, err, rel, rel_plain = True, 0.0, 0.0, 0.0
    for g, p32, r in zip(got, plain, ref64):
        r = r.double()
        e_k = (g.double() - r).abs()
        e_p = (p32.double() - r).abs()
        scale = r.abs().max().item()
        bad = e_k > e_p + PARITY_RTOL * r.abs() + PARITY_ATOL * scale
        ok = ok and not bad.any().item()
        err = max(err, (g - p32).abs().max().item())
        if scale > 0:
            rel = max(rel, e_k.max().item() / scale)
            rel_plain = max(rel_plain, e_p.max().item() / scale)
    return ok, err, rel, rel_plain


def held_to_plain(gk, args, kmax, logh, label):
    """One kernel call held to :func:`parity`'s rule; returns
    max |kernel - plain float32|."""
    import torch

    got = gk.fused_grams(*args, kmax, logh)
    torch.cuda.synchronize()
    ok, err, rel, _ = parity(gk, got, args, kmax, logh)
    check(ok, f"kernel disagrees at {label}: max |kernel-f64| / max|f64| "
              f"{rel:.3e}")
    print(f"parity {label} max|kernel-plain|={err:.3e}", flush=True)
    return err


def phase_kernel_parity(gk):
    """Kernel vs plain version on the card; returns the largest
    |kernel - plain float32|."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(N_FULL, BLOCK, c, R, k, lh) for c in (1, 3, 10) for R in (1, 2)
             for k in (1, 2, 3) for lh in (False, True)]
    cases += [(9_999, 2_000, 3, R, k, True) for R in (1, 2) for k in (1, 2, 3)]
    # the implicit path's shape: p_k rows (and a ragged p_k), blocks of
    # 8,192; log h only with the likelihood's kmax 1, as the solver asks
    cases += [(n, BLOCK_LARGE, C_LARGE, R, k, k == 1)
              for n in (PK_LARGE, PK_LARGE - 3) for R in (1, 2)
              for k in (1, 2, 3)]
    worst = 0.0
    for n, B, c, R, kmax, logh in cases:
        label = f"n={n} B={B} c={c} R={R} kmax={kmax} logh={int(logh)}"
        worst = max(worst, held_to_plain(gk, kernel_inputs(n, B, c, R, gen),
                                         kmax, logh, label))
    return worst


def kernel_time_row(gk, n, B, c, kmax, logh, gen):
    """K1's device, wall and plain times and bounds at one shape (R = 1)."""
    s = c + 1
    m = s * (s + 1) // 2
    args = kernel_inputs(n, B, c, 1, gen)
    call = lambda: gk.fused_grams(*args, kmax, logh)  # noqa: E731
    ms = device_ms(call, gk.KERNEL_NAMES)
    wall_ms = cuda_ms(call)
    plain_ms = cuda_ms(lambda: gk.fused_grams_reference(*args, kmax, logh))
    fp32, tf32, nbytes = gk.tensor_core_work(n, B, 1, m, s, kmax, logh)
    b_ms, b_by = gk.bound_ms(fp32, nbytes, tf32_flops=tf32)
    b1_ms, b1_by = gk.bound_ms(*gk.flops_and_bytes(n, B, 1, m, s, kmax,
                                                   logh))
    print(f"time n={n} B={B} c={c} kmax={kmax} logh={int(logh)}: kernel "
          f"{ms:.4f} ms device ({wall_ms:.4f} ms wall), plain {plain_ms:.4f} "
          f"ms, bound {b_ms:.4f} ms ({b_by}; FP32 pipes {b1_ms:.4f} ms, "
          f"{b1_by})", flush=True)
    return dict(ms=ms, wall_ms=wall_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, bound_fp32_ms=b1_ms, bound_fp32_by=b1_by)


def phase_kernel_times(gk):
    """K1's times at the dense path's shape by kmax (the kmax 3 row is the
    record's), and at the implicit path's shape at kmax 3."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {f"kmax{kmax}{'_logh' if logh else ''}":
            kernel_time_row(gk, N_FULL, BLOCK, C_FULL, kmax, logh, gen)
            for kmax, logh in ((1, True), (2, False), (3, False), (1, False))}
    implicit = kernel_time_row(gk, PK_LARGE, BLOCK_LARGE, C_LARGE, 3, False,
                               gen)
    return rows, implicit


def rotate_time_row(r, n, B, column_major, gen):
    """The rotation kernel at one block shape: its time a launch and
    torch.matmul's (CUDA events around back-to-back calls; a call is tens
    of ms, so host gaps are noise), its bound, and both errors against the
    float64 product, the kernel's held to at most twice cuBLAS's."""
    import torch

    from pygemma_tpu_torch.ops import rotate_kernel as rot

    U = (torch.randn(r, n, device="cuda", generator=gen).T if column_major
         else torch.randn(n, r, device="cuda", generator=gen)) / n ** 0.5
    p = torch.full((n, B), 0.3, device="cuda")
    X = ((torch.bernoulli(p, generator=gen) + torch.bernoulli(p, generator=gen)
          - 0.6) / 0.648).contiguous()
    del p
    got = rot.rotate_kernel(U, X)
    ref = torch.matmul(U.double().T, X.double())
    scale = ref.abs().max().item()
    err = (got.double() - ref).abs().max().item() / scale
    lib_err = (torch.matmul(U.T, X).double() - ref).abs().max().item() / scale
    del ref
    check(err <= 2.0 * lib_err,
          f"rotation r={r} n={n} B={B}: error {err:.3e} of max|C| against "
          f"cuBLAS float32's {lib_err:.3e}")
    check(torch.equal(got, rot.rotate_kernel(U, X)),
          f"rotation r={r} n={n} B={B}: two launches differ")
    ms = cuda_ms(lambda: rot.rotate_kernel(U, X), reps=5)
    lib_ms = cuda_ms(lambda: torch.matmul(U.T, X), reps=5)
    bound, by = rot.bound_ms(r, n, B)
    del U, X, got
    torch.cuda.empty_cache()
    print(f"rotate r={r} n={n} B={B} U {'column' if column_major else 'row'}"
          f"-major: kernel {ms:.3f} ms, torch.matmul {lib_ms:.3f} ms, bound "
          f"{bound:.3f} ms ({by}) = {100 * bound / ms:.1f}% of it; max err "
          f"{err:.3e} of max|C| (cuBLAS float32 {lib_err:.3e}, "
          f"{err / lib_err:.2f}x)", flush=True)
    return dict(ms=ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                roofline=bound / ms, max_rel_err=err, library_max_rel_err=lib_err)


def phase_rotate_times():
    """The rotation kernel's rows at :data:`ROTATE_SHAPES`."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    return {f"r={r} n={n} B={B}": rotate_time_row(r, n, B, cm, gen)
            for r, n, B, cm in ROTATE_SHAPES}


def reml_cases():
    """The REML kernel's launches at the benchmark cells' shapes: the dense
    scan's (n = 10,000, blocks of 2,048) and the 2-bit cohort's (a top
    space of 16,384 of n = 50,000 with the complement, blocks of 4,096),
    c = 3, in each mode of the search: the decade sweep's d1 over 11
    lambdas, a bisection step, a Newton step, the masked likelihood, the
    Wald step.  Yields (label, packed, lambda, keywords, need, step,
    valid, grid size)."""
    import torch

    from pygemma_tpu_torch.core.grams import (
        GramComplement, grams_per_snp_lambda_fused_packed,
        grams_shared_multi_packed)
    from pygemma_tpu_torch.core.solver import Bisect, Newton

    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, n, n_total, B in (("dense", N_FULL, N_FULL, BLOCK),
                                ("implicit", PK_LARGE, 50_000, 4_096)):
        lam, ev, pairs, sh, v = kernel_inputs(n, B, C_FULL, 1, gen)
        comp = None
        if n_total > n:
            s = sh.shape[1]
            E = torch.randn(64, s + B, device="cuda", generator=gen)
            R = E.T @ E
            comp = GramComplement(torch.tensor(EPS_LARGE, device="cuda"),
                                  n_total - n, R[:s, :s].contiguous(),
                                  R[s:, :s].contiguous(),
                                  torch.diagonal(R)[s:].contiguous())
        kw = dict(n=n_total, q=sh.shape[1], permute=True, restricted=True,
                  comp=comp)

        def packed(kmax, logh):
            return grams_per_snp_lambda_fused_packed(
                lam, ev, sh, pairs, v, tuple(range(1, kmax + 1)), logh)

        grid = torch.tensor([10.0 ** k for k in range(-5, 6)],
                            device="cuda")
        pg = grams_shared_multi_packed(grid, ev, sh, pairs, v, v * v, (1, 2))
        idx = torch.arange(B, device="cuda")
        bis = Bisect(lam * 0.5, lam * 3.0,
                     torch.where(idx % 2 == 0, 1.0, -1.0))
        newton = Newton(lam * 0.2, lam * 5.0, idx % 7 == 0, 1e-5)
        yield f"{name}.sweep_d1", pg, grid, kw, "d1", None, None, len(grid)
        yield f"{name}.bisect", packed(2, False), lam, kw, "d1", bis, None, 0
        yield (f"{name}.newton", packed(3, False), lam, kw, "newton", newton,
               None, 0)
        yield (f"{name}.lik", packed(1, True), lam, kw, "lik", None,
               idx % 3 != 0, 0)
        yield f"{name}.wald", packed(1, False), lam, kw, "wald", None, None, 0


def _reml_run(fn, need, packed, lam, kw, step, valid):
    """One call of ``fn`` on copies of lambda and of the step's state:
    (its output, lambda after it, the step state after it)."""
    import torch

    lam = lam.clone()
    if step is not None:
        step = type(step)(*(x.clone() if torch.is_tensor(x) else x
                            for x in step))
    return fn(need, packed, lam, step=step, valid=valid, **kw), lam, step


def _reml_close(a, b, scale, what):
    """``a`` against ``b`` at the gpu tests' tolerance: the same NaN and
    inf lanes, finite values within 1e-5 of |b| + ``scale``.  Returns
    (max |a - b| over b's finite lanes, the worst error over its
    tolerance)."""
    import torch

    a, b = a.double(), b.double()
    check(torch.equal(torch.isnan(a), torch.isnan(b)),
          f"REML kernel: NaN lanes differ ({what})")
    inf = torch.isinf(b)
    check(torch.equal(a[inf], b[inf]), f"REML kernel: inf lanes differ "
                                       f"({what})")
    ok = torch.isfinite(b)
    tol = 1e-5 * (b.abs() + (0.0 if scale is None else scale))
    err = (a - b).abs()
    err, tol = err[ok], torch.broadcast_to(tol, b.shape)[ok]
    if err.numel() == 0:
        return 0.0, 0.0
    ratio = torch.where(err == 0, 0.0, err / tol)
    return err.max().item(), ratio.max().item()


def _lik_terms(packed, lam, kw):
    """The size of the likelihood's terms, lane by lane: twice its
    constant plus |sum log h| (with the complement's n_comp log(lam eps +
    1)).  The log-likelihood is their difference with (n - q) log(y'P y) / 2
    and logdet / 2, each of which, given the likelihood, this bounds: at
    n = 50,000 the terms are ~1e5 and cancel, so float32 rounds the
    likelihood to ~1e-6 of them, not of itself."""
    import math

    from pygemma_tpu_torch.core import reml

    n, q = kw["n"], kw["q"]
    const = (reml.restricted_const(n, q) if kw["restricted"]
             else reml.ml_const(n))
    logh = packed.sums.sum_logh.double()
    comp = kw["comp"]
    if comp is not None:
        logh = logh + comp.n_comp * (lam.double() * comp.eps.item()
                                     + 1.0).log()
    return 2.0 * math.fabs(const) + logh.abs()


def _float64(packed, comp):
    """``packed`` and ``comp`` in float64: the plain version's yardstick."""
    from pygemma_tpu_torch.core.grams import GramSums, PackedGrams

    p = PackedGrams(packed.S.double(), packed.vS.double(),
                    packed.vv.double(),
                    GramSums(*(x.double() for x in packed.sums)))
    if comp is not None:
        comp = comp._replace(eps=comp.eps.double(), R_S=comp.R_S.double(),
                             R_vS=comp.R_vS.double(),
                             R_vv=comp.R_vv.double())
    return p, comp


def reml_parity(rk, label, packed, lam, kw, need, step=None, valid=None):
    """The REML kernel against its plain version on one launch's inputs,
    held to the gpu tests' rule: every decision equal (the bracket, the
    stopped lanes, x_ok), values within 1e-5 of |plain| + their scale
    (d1: n / lambda; d2: n / lambda^2; the Newton iterate: |d1 / d2| (1 +
    that / |d2|); beta and |z| = sqrt(F): the block's largest; the
    likelihood: its terms' size, :func:`_lik_terms`, where the likelihood
    also reports both versions' errors against the plain version in
    float64).  Returns (max |kernel - plain| over the plain version's
    finite values, the worst error over its tolerance)."""
    import torch

    from pygemma_tpu_torch.core import solver

    (ko, kl, ks), (po, pl, ps) = (
        _reml_run(fn, need, packed, lam, kw, step, valid)
        for fn in (rk.reml_kernel, solver.evaluate_plain))
    torch.cuda.synchronize()
    lam_d = lam.double()
    s1 = kw["n"] / (lam_d[:, None] if lam.shape != packed.vv.shape[:-1]
                    else lam_d)
    res = []
    if need == "d1" and step is None:
        res.append(_reml_close(ko, po, s1, f"{label} d1"))
    elif need == "d1":
        check(torch.equal(ks.lo, ps.lo) and torch.equal(ks.hi, ps.hi),
              f"REML kernel: the bracket differs ({label})")
        res.append(_reml_close(kl, pl, None, f"{label} midpoint"))
    elif need == "newton":
        d1, d2 = (x.double() for x in solver.evaluate_plain(
            "newton", packed, lam, **kw))
        s2 = s1 / lam_d
        if step is None:
            res += [_reml_close(ko[0], po[0], s1, f"{label} d1"),
                    _reml_close(ko[1], po[1], s2, f"{label} d2")]
        else:
            check(torch.equal(ks.done, ps.done),
                  f"REML kernel: the stopped lanes differ ({label})")
            res.append(_reml_close(kl, pl, (d1 / d2).abs()
                                   * (1 + s2 / d2.abs()),
                                   f"{label} iterate"))
    elif need == "lik":
        terms = _lik_terms(packed, lam, kw)
        res.append(_reml_close(ko, po, terms, f"{label} likelihood"))
        p64, c64 = _float64(packed, kw["comp"])
        ref = solver.evaluate_plain("lik", p64, lam.double(),
                                    **dict(kw, comp=c64), valid=valid)
        print(f"reml parity {label}: against float64, kernel "
              f"{_reml_close(ko, ref, terms, 'kernel')[1]:.3f} and plain "
              f"{_reml_close(po, ref, terms, 'plain')[1]:.3f} of the "
              f"tolerance", flush=True)
    else:
        check(torch.equal(ko[1], po[1]), f"REML kernel: x_ok differs "
                                         f"({label})")
        for i, col in enumerate(("beta", "se", "tau", "lambda", "F")):
            a, b = ko[0][i], po[0][i]
            if col == "F":
                a, b = a.sqrt(), b.sqrt()
            scale = (torch.nan_to_num(b.abs(), nan=0.0).max().item()
                     if col in ("beta", "F") else None)
            res.append(_reml_close(a, b, scale, f"{label} {col}"))
    err = max(r[0] for r in res)
    ratio = max(r[1] for r in res)
    check(ratio <= 1.0, f"REML kernel disagrees with its plain version at "
                        f"{label}: {ratio:.2f}x the tolerance")
    return err, ratio


def phase_reml_parity():
    """The REML kernel against its plain version in every mode at the
    cells' shapes (:func:`reml_cases`); returns the largest |kernel -
    plain| and the worst error over its tolerance."""
    from pygemma_tpu_torch.ops import reml_kernel as rk

    worst, worst_ratio = 0.0, 0.0
    for label, p, lm, kw, need, step, valid, _ in reml_cases():
        err, ratio = reml_parity(rk, label, p, lm, kw, need, step, valid)
        print(f"reml parity {label}: max|kernel-plain|={err:.3e}, "
              f"{ratio:.3f} of the tolerance", flush=True)
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    return worst, worst_ratio


def reml_time_row(rk, packed, lam, kw, need, step=None, valid=None,
                  grid=0):
    """The REML kernel's device and wall times for one launch, beside the
    plain PyTorch algebra's wall time on the same packed Grams (what an
    evaluation cost before the kernel) and the card's bound.  A step's
    calls each clone lambda first (both sides)."""
    from pygemma_tpu_torch.core import solver
    from pygemma_tpu_torch.ops import gram_kernel as gk

    st = {}

    def call(fn, state):
        fn(need, packed, lam.clone() if step else lam, step=state,
           valid=valid, **kw)

    if step is not None:
        st = {fn: type(step)(*(x.clone() if hasattr(x, "clone") else x
                               for x in step))
              for fn in (rk.reml_kernel, solver.evaluate_plain)}
    kern = lambda: call(rk.reml_kernel, st.get(rk.reml_kernel))  # noqa: E731
    plain = lambda: call(solver.evaluate_plain,  # noqa: E731
                         st.get(solver.evaluate_plain))
    ms = device_ms(kern, ("reml_kernel",))
    wall_ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain)
    lanes = int(packed.vv.shape[:-1].numel())
    flops, nbytes = rk.flops_and_bytes(
        kw["q"] + 1, lanes, need, step is not None, kw["comp"] is not None,
        grid)
    b_ms, b_by = gk.bound_ms(flops, nbytes)
    return dict(ms=ms, wall_ms=wall_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, lanes=lanes)


def phase_reml_times():
    """The REML kernel's times at the cells' shapes (:func:`reml_cases`).
    Prints one line a row and returns the rows."""
    from pygemma_tpu_torch.ops import reml_kernel as rk

    rows = {}
    for label, p, lm, kw, need, step, valid, g in reml_cases():
        row = reml_time_row(rk, p, lm, kw, need, step, valid, g)
        rows[label] = row
        print(f"reml {label} lanes={row['lanes']}: kernel "
              f"{row['ms'] * 1e3:.2f} us device ({row['wall_ms'] * 1e3:.2f}"
              f" us wall), plain {row['plain_ms'] * 1e3:.1f} us, bound "
              f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})",
              flush=True)
    return rows


def table_close_dlogp(got, ref, col, limit):
    import numpy as np

    a, b = got[col].to_numpy(), ref[col].to_numpy()
    check(np.array_equal(np.isnan(a), np.isnan(b)), f"{col}: NaN rows differ")
    ok = ~np.isnan(b)
    # p below 1e-300 (an underflow to 0 for a strong hit) counts as 1e-300
    a, b = np.maximum(a[ok], 1e-300), np.maximum(b[ok], 1e-300)
    d = float(np.max(np.abs(np.log10(a) - np.log10(b))))
    check(d < limit, f"{col}: max |d log10 p| {d:.3e} >= {limit}")
    return d


def phase_small(pt, oracle):
    import numpy as np

    # float32 on the card vs the float64 oracle (24 SNPs: the oracle is slow)
    y, G, W, K = oracle.simulate(n=1500, p=512, c=3, seed=42)
    ev, U = np.linalg.eigh(K)
    ev = np.maximum(ev, 0.0)
    t0 = time.time()
    ref = oracle.assoc_scan(ev, U.T @ W, U.T @ y, (U.T @ G)[:, :24])
    t_oracle = time.time() - t0
    df = pt.pygemma(y, G[:, :24], W, K, config=pt.GwasConfig(snp_block=24))
    d = float(np.max(np.abs(np.log10(df["p_wald"].to_numpy())
                            - np.log10(ref["p_wald"]))))
    check(d < SMALL_DLOGP, f"float32 card vs oracle: max |d log10 p| {d:.3e}")
    print(f"small: n=1500 24 SNPs float32 card vs oracle max|dlog10 p|="
          f"{d:.3e} (oracle {t_oracle:.1f} s)", flush=True)

    # float64 card vs float64 CPU
    y, G, W, K = oracle.simulate(n=300, p=40, c=3, seed=7)
    cfg = pt.GwasConfig(dtype="float64", snp_block=16)
    for name, kw in (("wald+lrt+score", {"tests": ("wald", "lrt", "score")}),
                     ("de", {"de": True}), ("grid", {"grid": True})):
        a = pt.pygemma(y, G, W, K, config=cfg, device="cuda", **kw)
        b = pt.pygemma(y, G, W, K, config=cfg, device="cpu", **kw)
        check(list(a.columns) == list(b.columns), f"{name}: columns differ")
        worst = 0.0
        for col in a.columns:
            x, z = a[col].to_numpy(), b[col].to_numpy()
            check(np.array_equal(np.isnan(x), np.isnan(z)),
                  f"{name} {col}: NaN rows differ")
            ok = ~np.isnan(z)
            rel = np.abs(x[ok] - z[ok]) / np.maximum(np.abs(z[ok]), 1e-300)
            check(np.allclose(x[ok], z[ok], rtol=CARD_CPU_RTOL, atol=1e-12),
                  f"{name} {col}: card vs CPU max rel {rel.max():.3e}")
            worst = max(worst, float(rel.max()))
        print(f"small: n=300 float64 card vs CPU [{name}] max rel {worst:.3e}",
              flush=True)


def make_full_width(seed: int = 2026):
    """simulate_gwas's recipe, drawn on the card from a seeded generator."""
    import torch

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    n, p, c = N_FULL, P_FULL, C_FULL
    maf = 0.05 + 0.45 * torch.rand(p, device=dev, generator=g)
    X = ((torch.rand(n, p, device=dev, generator=g) < maf).float()
         + (torch.rand(n, p, device=dev, generator=g) < maf).float())
    X -= X.mean(0)
    X /= torch.clamp_min(X.std(0, correction=0), 1e-6)
    K = X @ X.T / p
    K.diagonal().add_(1e-4)
    beta = torch.zeros(p, device=dev)
    causal = torch.randperm(p, device=dev, generator=g)[: p // 100]
    beta[causal] = torch.randn(causal.numel(), device=dev, generator=g)
    gvec = X @ beta
    gvec *= (0.4 ** 0.5) / gvec.std()
    # polygenic term with covariance X X'/p (= K - 1e-4 I)
    u = X @ torch.randn(p, device=dev, generator=g) / p ** 0.5
    u *= (0.3 ** 0.5) / u.std()
    e = torch.randn(n, device=dev, generator=g)
    e *= (0.3 ** 0.5) / e.std()
    W = torch.ones(n, c, device=dev)
    W[:, 1:] = torch.randn(n, c - 1, device=dev, generator=g)
    out = tuple(t.cpu().numpy() for t in (gvec + u + e, X, W, K))
    del X, K
    torch.cuda.empty_cache()
    return out


def pack_on_card(codes):
    """(n, b) uint8 codes on the card -> (ceil(n/4), b) packed bytes, in
    ``io.packed.pack_codes``'s bit order."""
    import torch

    pad = (-codes.shape[0]) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros((pad, codes.shape[1]))])
    c = codes.reshape(-1, 4, codes.shape[1])
    return c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)


def make_large_cohort(tmp: str, seed: int = 2027):
    """bench.py's large cohort (bench.py:75-84, :244-246), drawn on the
    card: binomial(2, 0.3) codes, packed there and written with
    ``write_rawbin_2bit``; per-SNP mean/sd sidecar; W = [1, N(0,1),
    N(0,1)].  Returns (prefix, W)."""
    import numpy as np
    import torch

    from pygemma_tpu_torch.io.packed import pack_codes, write_rawbin_2bit

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    n, p = N_LARGE, P_LARGE
    packed_pn = np.empty((p, (n + 3) // 4), np.uint8)
    mu = np.empty(p, np.float32)
    sd = np.empty(p, np.float32)
    for s in range(0, p, BLOCK_LARGE):
        b = min(BLOCK_LARGE, p - s)
        codes = sum((torch.rand(n, b, device=dev, generator=g) < 0.3).to(
            torch.uint8) for _ in range(2))
        xf = codes.float()
        mu[s:s + b] = xf.mean(0).cpu().numpy()
        sd[s:s + b] = torch.clamp_min(xf.std(0, correction=0),
                                      1e-6).cpu().numpy()
        packed = pack_on_card(codes)
        if s == 0:
            check(np.array_equal(packed[:, :64].cpu().numpy(),
                                 pack_codes(codes[:, :64].cpu().numpy())),
                  "packing on the card disagrees with pack_codes")
        packed_pn[s:s + b] = packed.T.cpu().numpy()
    prefix = os.path.join(tmp, "cohort")
    write_rawbin_2bit(prefix, packed_pn, mu, sd, n=n)
    W = torch.ones(n, C_LARGE, device=dev)
    W[:, 1:] = torch.randn(n, C_LARGE - 1, device=dev, generator=g)
    return prefix, W.cpu().numpy()


def large_inputs(tmp: str):
    """The large-GWAS path's inputs (bench.py:240-252), the cohort written
    under ``tmp``: (prefix, X, y, W, K, config), with y = 2 mean(X[:, :64])
    + N(0, 1) and K the GRM of the first PK_LARGE SNPs + EPS_LARGE I."""
    import numpy as np

    import pygemma_tpu_torch as pt
    from pygemma_tpu_torch.core.lowrank import LowRankKinship
    from pygemma_tpu_torch.io.packed import PackedMatrix

    prefix, W = make_large_cohort(tmp)
    X = PackedMatrix.open_rawbin(prefix)
    rng = np.random.default_rng(1)
    y = (2.0 * X[:, :64].mean(1) + rng.standard_normal(N_LARGE)).astype(
        np.float32)
    lrk = LowRankKinship(X.cols(0, PK_LARGE), eps=EPS_LARGE)
    return prefix, X, y, W, lrk, pt.GwasConfig(snp_block=BLOCK_LARGE)


def tables_equal(a, b, what):
    import numpy as np

    check(list(a.columns) == list(b.columns)
          and np.array_equal(a.to_numpy(), b.to_numpy(), equal_nan=True),
          f"{what}: the tables differ")


def lowrank_close(got, ref, what):
    """tests/test_lowrank.py's rule: |d log10 p| < 0.05, beta rtol 2e-3
    atol 1e-5, lambda rtol 5e-3, NaN rows equal."""
    import numpy as np

    d = table_close_dlogp(got, ref, "p_wald", LOWRANK_DLOGP)
    ok = ~np.isnan(ref["beta"].to_numpy())
    for col, rtol, atol in (("beta", LOWRANK_BETA_RTOL, LOWRANK_BETA_ATOL),
                            ("lambda", LOWRANK_LAM_RTOL, 0.0)):
        a, b = got[col].to_numpy()[ok], ref[col].to_numpy()[ok]
        bad = np.abs(a - b) > atol + rtol * np.abs(b)
        check(not bad.any(), f"{what} {col}: {int(bad.sum())} values off")
    return d


@contextlib.contextmanager
def plain_reml():
    """The REML kernel's plain version on the card: the λ search and the
    Wald step through ``solver.evaluate_plain``, as on the CPU."""
    from pygemma_tpu_torch.core import assoc, solver

    saved = solver.algebra, assoc.algebra
    solver.algebra = assoc.algebra = lambda x: solver.evaluate_plain
    try:
        yield
    finally:
        solver.algebra, assoc.algebra = saved


def held_to_float64(on, off, f64, cols):
    """The kernel-on table against the kernel-off table, both held to a
    float64 scan of the same block: per SNP, |on - f64| may exceed the plain
    float32 version's largest |off - f64| by OFF_BETA_RTOL * |f64|.
    Returns col -> (max |on - f64|, max |off - f64|, their median relative
    errors)."""
    import numpy as np

    out = {}
    for col in cols:
        a, b, r = (t[col].to_numpy() for t in (on, off, f64))
        ok = ~np.isnan(r)
        check(np.array_equal(np.isnan(a), np.isnan(r))
              and np.array_equal(np.isnan(b), np.isnan(r)),
              f"{col}: NaN rows differ from float64")
        e_on, e_off = np.abs(a[ok] - r[ok]), np.abs(b[ok] - r[ok])
        bad = e_on > e_off.max() + OFF_BETA_RTOL * np.abs(r[ok])
        check(not bad.any(), f"{col} kernel on: {int(bad.sum())} values "
                             "beyond the plain version's error")
        rel = np.abs(r[ok])
        out[col] = (float(e_on.max()), float(e_off.max()),
                    float(np.median(e_on / rel)),
                    float(np.median(e_off / rel)))
    return out


def phase_large(pt, gk, solver, tmp):
    """The large-GWAS path on the card, its cohort written under ``tmp``;
    returns its record and the (y, X, W, K, cfg) a later profile reuses."""
    import numpy as np
    import torch

    from pygemma_tpu_torch import api
    from pygemma_tpu_torch.core.lowrank import GRAM_BLOCK, lowrank_top_basis
    from pygemma_tpu_torch.io import streaming
    from pygemma_tpu_torch.io.packed import PackedMatrix, unpack_codes
    from pygemma_tpu_torch.io.plink import write_bed

    t0 = time.time()
    prefix, X, y, W, lrk, cfg = large_inputs(tmp)
    n_blocks = -(-P_LARGE // BLOCK_LARGE)
    block_bytes = streaming.SnpBlockStreamer(X, BLOCK_LARGE,
                                             device="cuda").block_bytes
    file_mb = os.path.getsize(prefix + ".2b") / 2**20
    print(f"large: cohort n={N_LARGE} p={P_LARGE} drawn on the card and "
          f"written ({file_mb:.0f} MiB) in {time.time() - t0:.1f} s",
          flush=True)

    # the top basis alone, by stage
    torch.cuda.synchronize()
    t0 = time.time()
    basis, stages = top_basis_stages(lambda: lowrank_top_basis(lrk))
    torch.cuda.synchronize()
    top_s = time.time() - t0
    check(bool(torch.isfinite(basis.U_top).all()), "top basis not finite")
    del basis
    torch.cuda.empty_cache()

    # cold: the basis and the scan in one driver call (the path's run)
    api._EIGEN_DEV_CACHE.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(gk, solver)
    solver.host_value.count = 0
    t0 = time.time()
    df = pt.pygemma(y, X, W, lrk, config=cfg,
                    run_dir=os.path.join(tmp, "cold"))
    e2e_s = time.time() - t0
    launches = gk.fused_grams.launches
    reml, evals = reml_launches(solver, n_blocks, "large")
    check(api._rotate_top.count == n_blocks,
          f"large: {api._rotate_top.count} top-space rotations for "
          f"{n_blocks} blocks")
    rot_launches = rotate_launches(n_blocks, "large")
    syncs = solver.host_value.count
    peak = torch.cuda.max_memory_allocated()
    check(launches > 0, "the kernel was never launched on the implicit "
                        "path")
    check(len(df) == P_LARGE, "wrong number of table rows")
    finite = float(np.isfinite(df["p_wald"].to_numpy()).mean())
    check(finite > 0.99, f"only {finite:.4f} of p_wald is finite")

    # warm: the basis from the device cache, a fresh run_dir
    t0 = time.time()
    df2 = pt.pygemma(y, X, W, lrk, config=cfg,
                     run_dir=os.path.join(tmp, "warm"))
    scan_s = time.time() - t0
    tables_equal(df2, df, "warm against cold")
    by_stage = ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
    print(f"large: top basis {top_s:.2f} s ({by_stage}), "
          f"end-to-end {e2e_s:.2f} s, warm scan {scan_s:.2f} s = "
          f"{P_LARGE / scan_s:.0f} SNPs/s; kernel launches {launches} "
          f"({launches / n_blocks:.1f} per block of {BLOCK_LARGE}); REML "
          f"kernel launches {reml} ({evals} evaluations); host "
          f"syncs {syncs}; peak device memory {peak / 2**30:.2f} GiB; "
          f"packed bytes per block {block_bytes}; finite p_wald "
          f"{finite:.4f}", flush=True)

    # (c) the first block: the device dequant against the host slice,
    # and the float32 ndarray input against the packed input
    first = X.cols(0, BLOCK_LARGE)
    (_, _, xb), = streaming.SnpBlockStreamer(first, BLOCK_LARGE,
                                             device="cuda")
    Xf = X[:, :BLOCK_LARGE]
    check(np.array_equal(xb.cpu().numpy(), Xf),
          "device dequant differs from the host slice")
    head = df.iloc[:BLOCK_LARGE].reset_index(drop=True)
    tables_equal(pt.pygemma(y, Xf, W, lrk, config=cfg), head,
                 "float32 input against packed input")
    del xb, Xf
    print("large: first block dequant bit-identical to the host slice; "
          "float32 input gives the identical table", flush=True)

    # (d) the device block cache, filled by the scan, then served.  A
    # basis computed while the cache is on streams (and caches) the
    # kinship's SNP columns too, as blocks of its own view
    kin_block = min(GRAM_BLOCK, PK_LARGE)
    kin_blocks = -(-PK_LARGE // kin_block)
    kin_bytes = kin_blocks * streaming.SnpBlockStreamer(
        lrk.G, kin_block, device="cuda").block_bytes
    os.environ["PYGEMMA_TPU_GENO_DEV_CACHE_MB"] = str(
        (n_blocks * block_bytes + kin_bytes) // 2**20 + 64)
    cache = streaming._DEV_BLOCK_CACHE
    try:
        streaming.clear_device_block_cache()
        fill = pt.pygemma(y, X, W, lrk, config=cfg)
        check(len(cache) == n_blocks,
              f"the cache holds {len(cache)} blocks, not {n_blocks}")
        t0 = time.time()
        hit = pt.pygemma(y, X, W, lrk, config=cfg)
        cached_s = time.time() - t0
        tables_equal(fill, df, "cache fill")
        tables_equal(hit, df, "cache hit")
        # the prefill thread racing the basis and the scan
        streaming.clear_device_block_cache()
        api._EIGEN_DEV_CACHE.clear()
        os.environ["PYGEMMA_TPU_PREFETCH_OVERLAP"] = "1"
        t0 = time.time()
        pipe = pt.pygemma(y, X, W, lrk, config=cfg)
        pipelined_s = time.time() - t0
        tables_equal(pipe, df, "prefill overlap")
        check(len(cache) == n_blocks + kin_blocks
              and cache.nbytes == cache.entry_bytes()
              == n_blocks * block_bytes + kin_bytes,
              f"cache after the prefill race: {len(cache)} blocks, "
              f"{cache.nbytes} counted, {cache.entry_bytes()} held")
    finally:
        os.environ.pop("PYGEMMA_TPU_GENO_DEV_CACHE_MB", None)
        os.environ.pop("PYGEMMA_TPU_PREFETCH_OVERLAP", None)
        streaming.clear_device_block_cache()
    print(f"large: cached scan {cached_s:.2f} s = {P_LARGE / cached_s:.0f} "
          f"SNPs/s ({n_blocks} blocks on the card, table identical); "
          f"prefill overlap end-to-end {pipelined_s:.2f} s (table "
          f"identical, byte count = entries)", flush=True)

    # (e) PLINK .bed coding: the same codes in both codings
    codes = unpack_codes(np.asarray(X.data[:, :BED_SNPS]), N_LARGE)
    write_bed(os.path.join(tmp, "slice"), codes.astype(np.float32))
    bed = PackedMatrix.open_bed(os.path.join(tmp, "slice"))
    dose = PackedMatrix.from_codes(np.ascontiguousarray(codes))
    check(np.array_equal(bed.mu, dose.mu) and np.array_equal(bed.sd, dose.sd),
          ".bed column statistics differ from the dosage coding's")
    for (start, stop, a), (_, _, b) in zip(
            streaming.SnpBlockStreamer(bed, 1024, device="cuda"),
            streaming.SnpBlockStreamer(dose, 1024, device="cuda")):
        m = stop - start  # padding columns decode per coding
        check(torch.equal(a[:, :m], b[:, :m]),
              ".bed blocks differ from the dosage coding's")
    print(f"large: .bed coding of {N_LARGE} x {BED_SNPS} streams "
          "bit-identical to the dosage coding", flush=True)

    # both kernels off on the first block (K1's and the REML kernel's plain
    # versions), both against the same block in float64; then the explicit
    # full basis
    with plain_reml():
        off = pt.pygemma(y, first, W, lrk,
                         config=cfg.replace(use_fused_kernel=False))
    f64 = pt.pygemma(y, X[:, :BLOCK_LARGE].astype(np.float64), W, lrk,
                     config=cfg.replace(dtype="float64"))
    d_off = table_close_dlogp(off, head, "p_wald", OFF_DLOGP)
    errs = held_to_float64(head, off, f64, ("beta", "lambda"))
    print("large: first block kernel on vs off max|dlog10 p|="
          f"{d_off:.3e}; against float64: " + "; ".join(
              f"{col} max abs on {on_e:.3e} off {off_e:.3e}, median rel "
              f"on {on_m:.3e} off {off_m:.3e}"
              for col, (on_e, off_e, on_m, off_m) in errs.items()),
          flush=True)
    t0 = time.time()
    exp = pt.pygemma(y, first, W, lrk,
                     config=cfg.replace(lowrank_implicit=False))
    explicit_s = time.time() - t0
    d_exp = lowrank_close(exp, head, "explicit against implicit")
    print(f"large: explicit n x n basis ({explicit_s:.1f} s) against "
          f"implicit max|dlog10 p|={d_exp:.3e}", flush=True)
    api._EIGEN_DEV_CACHE.clear()
    torch.cuda.empty_cache()
    record = dict(launches=launches, reml_launches=reml, evaluations=evals,
                  rotate_launches=rot_launches,
                  host_syncs=syncs, top_basis_s=top_s,
                  top_basis_stages=stages, e2e_s=e2e_s, scan_s=scan_s,
                  snps_per_s=P_LARGE / scan_s, cached_scan_s=cached_s,
                  pipelined_e2e_s=pipelined_s,
                  explicit_first_block_s=explicit_s, peak_gib=peak / 2**30,
                  packed_bytes_per_block=block_bytes, finite_p=finite,
                  on_off_dlogp=d_off, on_off_vs_float64=errs,
                  explicit_implicit_dlogp=d_exp)
    return record, dict(y=y, X=X, W=W, lrk=lrk, cfg=cfg, table=df,
                        head=head, f64_head=f64, prefix=prefix)


def table_diffs(got, ref, what, se_col="se_beta", hold_beta=True):
    """Two float32 tables of the same scan that differ only in rounding
    (a batched against a looped scan, one rotation of Y against
    another): NaN rows equal and |d log10 p_wald| < OFF_DLOGP; with
    ``hold_beta``, also |d beta| <= OFF_BETA_RTOL (|beta| + se), i.e.
    within half a percent of beta's own standard error where beta sits
    near 0.  Returns (max |d log10 p|, max |d beta| / (|beta| + se), the
    number of SNPs beyond OFF_BETA_RTOL)."""
    import numpy as np

    d = table_close_dlogp(got, ref, "p_wald", OFF_DLOGP)
    a, b = got["beta"].to_numpy(), ref["beta"].to_numpy()
    se = ref[se_col].to_numpy()
    ok = ~np.isnan(b)
    rel = np.abs(a[ok] - b[ok]) / (np.abs(b[ok]) + se[ok])
    over = int((rel > OFF_BETA_RTOL).sum())
    check(not (hold_beta and over),
          f"{what}: beta off by {rel.max():.3e} of |beta| + se")
    return d, float(rel.max()), over


def multi_phenotypes(y, X):
    """bench.py:408-412: y and K_PHENOS - 1 phenotypes driven by the mean of
    SNP slices 64 (i+1) .. 64 (i+2)."""
    import numpy as np

    cols = [y]
    for i in range(K_PHENOS - 1):
        sl = np.asarray(X[:, 64 * (i + 1):64 * (i + 1) + 64])
        cols.append((0.2 * sl.mean(1) * 8.0
                     + np.random.default_rng(i + 2).standard_normal(X.shape[0])
                     ).astype(np.float32))
    return np.column_stack(cols)


def phase_multi(pt, gk, solver, ctx, tmp):
    """Phase 9: the batched k = 4 scan on the large-GWAS path."""
    import numpy as np
    import pandas as pd
    import torch

    from pygemma_tpu_torch import api

    y, X, W, lrk, cfg = (ctx[k] for k in ("y", "X", "W", "lrk", "cfg"))
    Yk = multi_phenotypes(y, X)
    n_blocks = -(-P_LARGE // BLOCK_LARGE)
    first = X.cols(0, BLOCK_LARGE)
    t0 = time.time()
    pt.pygemma(Yk, first, W, lrk, config=cfg)  # warm: the basis, one block
    warm_s = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(gk, solver)
    solver.host_value.count = 0
    t0 = time.time()
    dfk = pt.pygemma(Yk, X, W, lrk, config=cfg)  # the path's run
    multi_s = time.time() - t0
    launches = gk.fused_grams.launches
    reml, evals = reml_launches(solver, n_blocks * K_PHENOS, "multi")
    rotations = api._rotate_top.count
    syncs = solver.host_value.count
    peak = torch.cuda.max_memory_allocated()
    check(launches > 0, "the kernel was never launched on the batched path")
    check(rotations == n_blocks,
          f"{rotations} top-space rotations for {n_blocks} blocks")
    rot_launches = rotate_launches(rotations, "multi")
    check(len(dfk) == K_PHENOS * P_LARGE, "wrong number of table rows")
    finite = float(np.isfinite(dfk["p_wald"].to_numpy()).mean())
    check(finite > 0.99, f"only {finite:.4f} of p_wald is finite")
    rate = K_PHENOS * P_LARGE / multi_s
    print(f"multi: k={K_PHENOS} batched scan of p={P_LARGE} {multi_s:.2f} s "
          f"= {rate:.0f} SNP-tests/s (warm-up block and basis {warm_s:.2f} "
          f"s); kernel launches {launches} ({launches / n_blocks:.1f} per "
          f"block); REML kernel launches {reml} ({evals} evaluations); "
          f"U_top'xb GEMMs {rotations} ({rotations / n_blocks:.1f} "
          f"per block); host syncs {syncs}; peak device memory "
          f"{peak / 2**30:.2f} GiB; finite p_wald {finite:.4f}", flush=True)

    # phenotype 0 against phase 5's single-phenotype table: every row, and
    # the first block held to phase 5's float64 scan of it
    p0 = dfk[dfk["pheno"] == 0].drop(columns="pheno").reset_index(drop=True)
    d0, b0, _ = table_diffs(p0, ctx["table"], "pheno 0 against phase 5")
    errs = held_to_float64(p0.iloc[:BLOCK_LARGE], ctx["head"],
                           ctx["f64_head"], ("beta", "lambda"))
    # the first block against the looped scan of the same four phenotypes
    rotations_before = api._rotate_top.count
    looped = pt.pygemma(Yk, first, W, lrk, config=cfg,
                        run_dir=os.path.join(tmp, "multi_looped"))
    looped_rot = api._rotate_top.count - rotations_before
    check(looped_rot == K_PHENOS,
          f"the looped block was rotated {looped_rot} times")
    head = pd.concat([dfk.iloc[g * P_LARGE:g * P_LARGE + BLOCK_LARGE]
                      for g in range(K_PHENOS)], ignore_index=True)
    d1, b1, _ = table_diffs(head, looped.reset_index(drop=True),
                            "first block batched against looped")
    print(f"multi: pheno 0 against phase 5 max|dlog10 p|={d0:.3e}, beta "
          f"{b0:.3e} of |beta|+se; first block against float64: " + "; ".join(
              f"{col} max abs {on_e:.3e} (single {off_e:.3e})"
              for col, (on_e, off_e, _, _) in errs.items())
          + f"; first block batched against looped ({looped_rot} rotations) "
          f"max|dlog10 p|={d1:.3e}, beta {b1:.3e} of |beta|+se", flush=True)
    api._EIGEN_DEV_CACHE.clear()
    torch.cuda.empty_cache()
    return dict(k=K_PHENOS, launches=launches, reml_launches=reml,
                rotate_launches=rot_launches,
                evaluations=evals, rotations=rotations,
                rotations_per_block=rotations / n_blocks,
                looped_rotations_per_block=looped_rot, host_syncs=syncs,
                scan_s=multi_s, warm_s=warm_s, snp_tests_per_s=rate,
                peak_gib=peak / 2**30, finite_p=finite,
                pheno0_dlogp=d0, pheno0_beta=b0, pheno0_vs_float64=errs,
                looped_dlogp=d1, looped_beta=b1)


def write_plink_cohort(tmp: str, seed: int = 2028):
    """An n = N_FULL x p = P_FULL PLINK fileset: per-SNP MAF ~ U(0.05,
    0.5), binomial(2, MAF) dosages drawn on the card, mapped to .bed codes
    (2 -> 00, 1 -> 10, 0 -> 11) and packed there, written SNP-major; a
    4-column phenotype TSV, each with heritability 0.3 spread over every
    SNP (sim.simulate_gwas's polygenic recipe), phenotype 0 also carrying
    SNP 17 with a z of about 10 at this n; a 2-column covariate file.
    Returns (prefix, pheno path, covariate path)."""
    import numpy as np
    import torch

    from pygemma_tpu_torch.io.bimbam import write_matrix
    from pygemma_tpu_torch.io.plink import _MAGIC, write_bim_fam

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    n, p = N_FULL, P_FULL
    prefix = os.path.join(tmp, "cohort_bed")
    lut = torch.tensor([3, 2, 0], dtype=torch.uint8, device=dev)
    # each phenotype's polygenic term, u = X_std b / sqrt(p) (heritability
    # 0.3 below), summed over the blocks as they are drawn
    u = torch.zeros(n, K_PHENOS, device=dev, dtype=torch.float64)
    with open(prefix + ".bed", "wb") as f:
        f.write(_MAGIC)
        for s in range(0, p, BLOCK_LARGE):
            b = min(BLOCK_LARGE, p - s)
            maf = 0.05 + 0.45 * torch.rand(b, device=dev, generator=g)
            dose = sum((torch.rand(n, b, device=dev, generator=g) < maf).to(
                torch.uint8) for _ in range(2))
            xs = dose.double()
            xs = (xs - xs.mean(0)) / torch.clamp_min(xs.std(0), 1e-6)
            if s == 0:
                x17 = xs[:, 17].clone()
            u += xs @ torch.randn(b, K_PHENOS, device=dev, generator=g,
                                  dtype=torch.float64)
            f.write(pack_on_card(lut[dose.long()]).T.contiguous()
                    .cpu().numpy().tobytes())
    write_bim_fam(prefix, n, p)
    e = torch.randn(n, K_PHENOS, device=dev, generator=g, dtype=torch.float64)
    Y = 0.3 ** 0.5 * u / u.std(0) + 0.7 ** 0.5 * e / e.std(0)
    Y[:, 0] += 0.1 * x17
    pheno = os.path.join(tmp, "pheno.tsv")
    with open(pheno, "w") as f:
        f.write("\t".join(f"y{i}" for i in range(K_PHENOS)) + "\n")
        np.savetxt(f, Y.cpu().numpy(), fmt="%.8g", delimiter="\t")
    covar = os.path.join(tmp, "covar.txt")
    write_matrix(covar, torch.randn(n, 2, device=dev, generator=g,
                                    dtype=torch.float64).cpu().numpy())
    return prefix, pheno, covar


def run_cli(args, label):
    """``python -m pygemma_tpu_torch run ...`` as a subprocess from the
    checkout; returns (seconds, stage -> seconds, K1's launches, the REML
    kernel's launches)."""
    import re

    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "pygemma_tpu_torch", "run",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT)
    wall = time.time() - t0
    check(proc.returncode == 0,
          f"CLI {label} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    stages = {}
    for line in proc.stderr.splitlines():
        m = re.fullmatch(r"(.+) - ([0-9.]+) s", line.strip())
        if m:
            stages[m.group(1)] = stages.get(m.group(1), 0.0) + float(
                m.group(2))
    m = re.search(r"fused Gram kernel launches (\d+); REML kernel launches "
                  r"(\d+)", proc.stderr)
    check(m is not None, f"CLI {label}: no launch count in its log")
    return wall, stages, int(m.group(1)), int(m.group(2))


def startup_seconds():
    """What a CLI process spends before its first stage: (wall seconds of
    a process that imports the command line and torch and makes the CUDA
    context, and the seconds of that inside the interpreter)."""
    code = ("import time; t = time.time(); import torch, "
            "pygemma_tpu_torch.__main__; torch.zeros(1, device='cuda'); "
            "torch.cuda.synchronize(); print(time.time() - t)")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"CLI start-up probe: {proc.stderr[-2000:]}")
    return time.time() - t0, float(proc.stdout.split()[-1])


def stage_summary(stages):
    """The CLI's stage log as read, GRM, eigh, scan (null fits, rotation of
    W and Y, the association scan) and write seconds."""
    out = {"read": 0.0, "grm": 0.0, "eigh": 0.0, "broadcast": 0.0,
           "scan": 0.0, "write": 0.0}
    for name, sec in stages.items():
        key = ("read" if name.startswith("read") else
               "grm" if name.startswith("kinship") else
               "eigh" if name.startswith("eigendecomposition") else
               "broadcast" if name.startswith("broadcast") else
               "write" if name.startswith("write") else "scan")
        out[key] += sec
    return out


def phase_cli(tmp):
    """Phase 10: the command line on a PLINK cohort at the dense shape."""
    import numpy as np
    import pandas as pd
    import torch

    from pygemma_tpu_torch.io.kinship import kinship_blocked
    from pygemma_tpu_torch.io.plink import read_bed

    t0 = time.time()
    prefix, pheno, covar = write_plink_cohort(tmp)
    mb = os.path.getsize(prefix + ".bed") / 2**20
    print(f"cli: PLINK cohort n={N_FULL} p={P_FULL} drawn on the card and "
          f"written ({mb:.0f} MiB) in {time.time() - t0:.1f} s", flush=True)

    # the native decode against NumPy's; the GRM against float64 NumPy
    sl = range(BED_SNPS)
    nat = read_bed(prefix, snp_indices=sl).X
    check(np.array_equal(nat, read_bed(prefix, snp_indices=sl,
                                       use_native=False).X),
          "native .bed decode differs from the NumPy decode")
    t0 = time.time()
    X = read_bed(prefix).X
    read_s = time.time() - t0
    K = kinship_blocked(X, device="cuda")[:GRM_CHECK, :GRM_CHECK]
    mu = X.mean(0, dtype=np.float64)
    Xc = X[:GRM_CHECK].astype(np.float64) - mu
    K64 = Xc @ Xc.T / P_FULL
    # entries near 0 need the absolute term: 1e-5 of the diagonal's scale
    grm_err = float(np.max(np.abs(K - K64) / (np.abs(K64)
                                              + np.abs(K64).max())))
    check(np.allclose(K, K64, rtol=GRM_RTOL,
                      atol=GRM_RTOL * np.abs(K64).max()),
          f"GRM against float64: max rel {grm_err:.3e}")
    del X, Xc, K, K64
    torch.cuda.empty_cache()
    print(f"cli: native decode of {BED_SNPS} SNPs bit-identical to NumPy's; "
          f"full decode {read_s:.2f} s; K[:{GRM_CHECK}, :{GRM_CHECK}] against "
          f"float64 max |d| / (|K| + max|K|) {grm_err:.3e}", flush=True)

    start_wall, start_in = startup_seconds()
    print(f"cli: a process that imports the CLI and torch and makes the CUDA "
          f"context takes {start_wall:.2f} s ({start_in:.2f} s of it after "
          "the interpreter starts)", flush=True)
    out1 = os.path.join(tmp, "assoc.tsv")
    common = ["--bfile", prefix, "--pheno", pheno, "--covar", covar,
              "--add-intercept", "--gk", "1"]
    wall1, st1, launches1, reml1 = run_cli(common + ["--out", out1],
                                           "run 1")
    s1 = stage_summary(st1)
    print(f"cli: run 1 (k={K_PHENOS}, TSV): {wall1:.2f} s wall; " + ", ".join(
        f"{k} {v:.2f} s" for k, v in s1.items())
        + f"; kernel launches {launches1}, REML kernel launches {reml1}",
        flush=True)
    out2 = os.path.join(tmp, "pheno0.assoc.txt")
    wall2, st2, launches2, reml2 = run_cli(
        common + ["--pheno-col", "0", "--tests", "wald,lrt,score",
                  "--out-format", "gemma", "--out", out2], "run 2")
    s2 = stage_summary(st2)
    print(f"cli: run 2 (pheno 0, wald+lrt+score, GEMMA): {wall2:.2f} s wall; "
          + ", ".join(f"{k} {v:.2f} s" for k, v in s2.items())
          + f"; kernel launches {launches2}, REML kernel launches {reml2}",
          flush=True)
    check(launches1 > 0 and launches2 > 0,
          f"the CLI runs launched the kernel {launches1} and {launches2} "
          "times")
    check(reml1 > 0 and reml2 > 0,
          f"the CLI runs launched the REML kernel {reml1} and {reml2} times")

    t1 = pd.read_csv(out1, sep="\t")
    check(len(t1) == K_PHENOS * P_FULL, f"run 1 has {len(t1)} rows")
    finite = float(np.isfinite(t1["p_wald"].to_numpy()).mean())
    check(finite >= 0.99, f"run 1: only {finite:.4f} of p_wald is finite")
    t2 = pd.read_csv(out2, sep="\t")
    check(list(t2.columns) == [
        "chr", "rs", "ps", "n_miss", "allele1", "allele0", "af", "beta",
        "se", "logl_H1", "l_remle", "l_mle", "p_wald", "p_lrt", "p_score"],
        f"run 2's GEMMA columns: {list(t2.columns)}")
    check(len(t2) == P_FULL and bool((t2["n_miss"] == -9).all()),
          "run 2: wrong rows or n_miss is not GEMMA's -9")
    for col in ("p_lrt", "p_score"):
        fin = float(np.isfinite(t2[col].to_numpy()).mean())
        check(fin >= 0.99, f"run 2: only {fin:.4f} of {col} is finite")
    p0 = t1[t1["pheno"] == 0].reset_index(drop=True)
    check(list(t2["rs"]) == list(p0["SNPs"]), "run 2's SNPs differ")
    # p_wald is held; beta is reported: where a SNP's REML optimum sits on
    # a flat ridge, rounding y differently (one rotation of (n, 4) against
    # one of (n, 1)) can move its lambda, and beta with it
    d, b, over = table_diffs(t2, p0, "run 2 against run 1's pheno 0",
                             hold_beta=False)
    hit = int(p0["p_wald"].idxmin())
    print(f"cli: run 1 {len(t1)} rows, finite p_wald {finite:.4f}, pheno 0 "
          f"top hit rs{hit}; run 2 against run 1's pheno 0 max|dlog10 p|="
          f"{d:.3e}; beta max {b:.3e} of |beta|+se, {over} of {P_FULL} SNPs "
          f"beyond {OFF_BETA_RTOL}", flush=True)
    return dict(launches_run1=launches1, launches_run2=launches2,
                reml_launches_run1=reml1, reml_launches_run2=reml2,
                startup_wall_s=start_wall, startup_in_process_s=start_in,
                wall_run1_s=wall1, wall_run2_s=wall2, stages_run1=s1,
                stages_run2=s2, finite_p=finite, grm_err=grm_err,
                run2_vs_run1_dlogp=d, run2_vs_run1_beta=b,
                run2_vs_run1_beta_over=over, top_hit=hit), dict(
        common=common, run2=out2, wall_run2_s=wall2, stages_run2=s2)


def mesh_rank_large(tmp: str, prefix: str) -> None:
    """Phase 11a in one rank of the group: phase 5's configuration over a
    2-rank mesh, a warm-up call (the basis on rank 0 and its broadcast,
    read from rank 0's stage log) then a timed call; writes the rank's
    table and numbers under ``tmp``."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    import pygemma_tpu_torch as pt
    from pygemma_tpu_torch.core import solver
    from pygemma_tpu_torch.core.lowrank import LowRankKinship
    from pygemma_tpu_torch.io.packed import PackedMatrix
    from pygemma_tpu_torch.ops import gram_kernel as gk
    from pygemma_tpu_torch.parallel.distributed import all_sum
    from pygemma_tpu_torch.parallel.mesh import make_mesh

    t_start = time.time()
    mesh = make_mesh(snp=MESH_RANKS)
    rank = dist.get_rank()
    X = PackedMatrix.open_rawbin(prefix)
    y, W = (np.load(os.path.join(tmp, f"{k}.npy")) for k in ("y", "W"))
    lrk = LowRankKinship(X.cols(0, PK_LARGE), eps=EPS_LARGE)
    cfg = pt.GwasConfig(snp_block=BLOCK_LARGE)
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    t0 = time.time()
    setup_s = t0 - t_start
    with contextlib.redirect_stderr(log):
        pt.pygemma(y, X, W, lrk, config=cfg, mesh=mesh, verbose=1)
    first_s = time.time() - t0
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(.+) - ([0-9.]+) s$", log.getvalue(), re.M)}
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches(gk, solver)
    t0 = time.time()
    df = pt.pygemma(y, X, W, lrk, config=cfg, mesh=mesh)  # the path's run
    torch.cuda.synchronize()
    scan_s = time.time() - t0
    launches = gk.fused_grams.launches
    reml, evals = reml_launches(solver, None, f"mesh rank {rank}")
    # this rank's share of each block, rotated into the top space
    rot = rotate_launches(pt.api._rotate_top.count, f"mesh rank {rank}")
    record = dict(rank=rank, backend=dist.get_backend(),
                  device=str(torch.cuda.current_device()),
                  setup_s=setup_s, first_call_s=first_s,
                  stages=stages, scan_s=scan_s, launches=launches,
                  launches_all_ranks=all_sum(launches),
                  rotate_launches_all_ranks=all_sum(rot),
                  reml_launches_all_ranks=all_sum(reml),
                  evaluations_all_ranks=all_sum(evals),
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    np.save(os.path.join(tmp, f"mesh_rank{rank}.npy"),
            df.to_numpy(dtype=np.float64))
    with open(os.path.join(tmp, f"mesh_rank{rank}.json"), "w") as f:
        json.dump(record, f)


def phase_mesh_large(ctx, large, prefix, tmp):
    """Phase 11a: two ranks on the one card over phase 5's cohort."""
    import numpy as np

    from pygemma_tpu_torch.parallel.distributed import spawn

    np.save(os.path.join(tmp, "y.npy"), ctx["y"])
    np.save(os.path.join(tmp, "W.npy"), ctx["W"])
    t0 = time.time()
    spawn(mesh_rank_large, MESH_RANKS, (tmp, prefix))
    wall = time.time() - t0
    recs = []
    for r in range(MESH_RANKS):
        with open(os.path.join(tmp, f"mesh_rank{r}.json")) as f:
            recs.append(json.load(f))
    tabs = [np.load(os.path.join(tmp, f"mesh_rank{r}.npy"))
            for r in range(MESH_RANKS)]
    for r in range(1, MESH_RANKS):
        check(np.array_equal(tabs[0], tabs[r], equal_nan=True),
              f"rank {r}'s table differs from rank 0's")
    ref = ctx["table"]
    cols = list(ref.columns)
    got = {c: tabs[0][:, i] for i, c in enumerate(cols)}
    check(tabs[0].shape == ref.shape, f"mesh table shape {tabs[0].shape}")
    a, b = got["p_wald"], ref["p_wald"].to_numpy()
    check(np.array_equal(np.isnan(a), np.isnan(b)), "mesh: NaN rows differ")
    ok = ~np.isnan(b)
    dl = np.abs(np.log10(np.maximum(a[ok], 1e-300))
                - np.log10(np.maximum(b[ok], 1e-300)))
    d, share = float(dl.max()), float((dl > 1e-3).mean())
    check(d < MESH_DLOGP, f"mesh vs phase 5: max |d log10 p| {d:.3e}")
    launches = recs[0]["launches_all_ranks"]
    check(launches > 0, "the kernel was never launched on the mesh path")
    reml = recs[0]["reml_launches_all_ranks"]
    check(all(rec["backend"] == "gloo" for rec in recs),
          f"backends {[rec['backend'] for rec in recs]}, not gloo")
    st = recs[0]["stages"]
    basis_s = st.get("implicit low-rank eigendecomposition")
    bcast_s = st.get("broadcast of the eigenbasis")
    check(basis_s is not None and bcast_s is not None,
          f"rank 0's stage log lacks the basis or its broadcast: {st}")
    scan_s = max(rec["scan_s"] for rec in recs)
    print(f"mesh: {MESH_RANKS} ranks on one card (gloo), phase 5's cohort: "
          f"basis on rank 0 {basis_s:.2f} s, its broadcast {bcast_s:.2f} s; "
          f"warm scan {scan_s:.2f} s (slower rank; ranks "
          + ", ".join(f"{rec['scan_s']:.2f}" for rec in recs)
          + f") against phase 5's {large['scan_s']:.2f} s in one process; "
          f"K1 launches {launches} over the ranks (phase 5: "
          f"{large['launches']}); peak memory "
          + ", ".join(f"{rec['peak_gib']:.2f}" for rec in recs)
          + f" GiB; vs phase 5 max|dlog10 p|={d:.3e}, {share:.4%} of SNPs "
          f"above 1e-3; tables identical across ranks; {wall:.1f} s wall "
          "with the processes' start", flush=True)
    return dict(ranks=MESH_RANKS, backend="gloo", launches=launches,
                reml_launches=reml,
                rotate_launches=recs[0]["rotate_launches_all_ranks"],
                evaluations=recs[0]["evaluations_all_ranks"], basis_s=basis_s, broadcast_s=bcast_s, scan_s=scan_s,
                scan_s_by_rank=[rec["scan_s"] for rec in recs],
                first_call_s=[rec["first_call_s"] for rec in recs],
                phase5_scan_s=large["scan_s"],
                peak_gib_by_rank=[rec["peak_gib"] for rec in recs],
                vs_phase5_dlogp=d, vs_phase5_share_above_1e3=share,
                wall_s=wall)


def phase_mesh_cli(tmp, files):
    """Phase 11b: the command line with --mesh 2 against phase 10's run 2."""
    import pandas as pd

    out = os.path.join(tmp, "pheno0_mesh.assoc.txt")
    wall, stages, launches, reml = run_cli(
        files["common"] + ["--pheno-col", "0", "--tests", "wald,lrt,score",
                           "--out-format", "gemma", "--out", out,
                           "--mesh", str(MESH_RANKS)], "--mesh 2")
    check(launches > 0, "the --mesh CLI run never launched the kernel")
    check(reml > 0, "the --mesh CLI run never launched the REML kernel")
    got, ref = pd.read_csv(out, sep="\t"), pd.read_csv(files["run2"], sep="\t")
    check(list(got.columns) == list(ref.columns) and len(got) == len(ref),
          "the --mesh table's shape or columns differ from run 2's")
    d = {col: table_close_dlogp(got, ref, col, MESH_DLOGP)
         for col in ("p_wald", "p_lrt", "p_score")}
    s = stage_summary(stages)
    print(f"mesh: CLI --mesh {MESH_RANKS} (pheno 0, wald+lrt+score, GEMMA): "
          f"{wall:.2f} s wall (run 2 in one process "
          f"{files['wall_run2_s']:.2f} s); " + ", ".join(
              f"{k} {v:.2f} s" for k, v in s.items())
          + f"; kernel launches {launches} over the ranks; against run 2 "
          + ", ".join(f"{k} max|dlog10 p|={v:.3e}" for k, v in d.items()),
          flush=True)
    return dict(launches=launches, reml_launches=reml, wall_s=wall, stages=s,
                run2_wall_s=files["wall_run2_s"], vs_run2_dlogp=d)


def phase_mesh_nccl(pt, oracle):
    """Phase 11c: a one-rank NCCL mesh in this process; the eigenbasis, the
    null fit and the table go through NCCL's broadcast and gather of device
    tensors."""
    import numpy as np
    import torch.distributed as dist

    from pygemma_tpu_torch.parallel.mesh import make_mesh

    y, G, W, K = oracle.simulate(n=NCCL_N, p=NCCL_P, c=3, seed=11)
    cfg = pt.GwasConfig(dtype="float64", snp_block=NCCL_BLOCK,
                        tests=("wald", "lrt", "score"))
    ref = pt.pygemma(y, G, W, K, config=cfg)
    pt.api._EIGEN_DEV_CACHE.clear()  # the mesh run broadcasts its basis
    mesh = make_mesh(snp=1)
    try:
        backend = dist.get_backend()
        check(backend == "nccl", f"one rank with a card took {backend}")
        t0 = time.time()
        got = pt.pygemma(y, G, W, K, config=cfg, mesh=mesh)
        mesh_s = time.time() - t0
    finally:
        dist.destroy_process_group()
        pt.api._EIGEN_DEV_CACHE.clear()
    check(list(got.columns) == list(ref.columns), "columns differ")
    worst = 0.0
    for col in ref.columns:
        a, b = got[col].to_numpy(), ref[col].to_numpy()
        check(np.array_equal(np.isnan(a), np.isnan(b)),
              f"NCCL mesh {col}: NaN rows differ")
        ok = ~np.isnan(b)
        check(np.allclose(a[ok], b[ok], rtol=CARD_CPU_RTOL, atol=1e-12),
              f"NCCL mesh {col} differs from the scan without a mesh")
        rel = np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), 1e-300)
        worst = max(worst, float(rel.max()))
    print(f"mesh: one-rank NCCL mesh, n={NCCL_N} p={NCCL_P} float64 "
          f"wald+lrt+score, against no mesh max rel {worst:.3e} "
          f"({mesh_s:.2f} s)", flush=True)
    return dict(backend=backend, n=NCCL_N, p=NCCL_P, max_rel=worst,
                seconds=mesh_s)


def top_basis_stages(fn):
    """``fn()`` (a top basis) with tracing on: (its result, the device
    seconds of its three ``lowrank.*`` stage spans by stage)."""
    from pygemma_tpu_torch.utils import profiling

    profiling.enable()
    try:
        out = fn()
        spans = profiling.collect()
    finally:
        profiling.disable()
    return out, {s.name.split(".")[1] + "_s": s.device_ns / 1e9
                 for s in spans if s.name.startswith("lowrank.")}


def dc_verbose(fn):
    """``fn()`` with eigh_dc's per-split lines on (PYGEMMA_TPU_DC_VERBOSE):
    returns (its result, the lines), echoing the lines."""
    import contextlib
    import io

    buf = io.StringIO()
    os.environ["PYGEMMA_TPU_DC_VERBOSE"] = "1"
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    finally:
        os.environ.pop("PYGEMMA_TPU_DC_VERBOSE", None)
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(line, flush=True)
    return out, lines


def dc_split_stats(lines, n):
    """The depth-0 split of an n x n eigh_dc from its verbose lines: sign
    attempts, the accepted attempt's schedule rows and polish rounds, the
    NaN rescales, the range-find retries, r_lo and the accepted coupling."""
    import re

    head = f"[eigh_dc] n={n} depth=0 "
    rows = [re.search(r"sched=(\d+) polish=(\d+)", line)
            for line in lines if line.startswith(head + "attempt=")
            and "sched=" in line]
    check(bool(rows), f"no depth-0 split line for n={n}: {lines[:5]}")
    split = [re.search(r"r_lo=(\d+)", line) for line in lines
             if line.startswith(head + "split")]
    coupling = [re.search(r"coupling ([0-9.e+-]+)", line) for line in lines
                if line.startswith(head + "ranges+pencil+coupling")]
    return dict(
        sign_attempts=len(rows), sched_rows=int(rows[-1].group(1)),
        polish_rounds=int(rows[-1].group(2)),
        sign_steps=sum(int(m.group(1)) + int(m.group(2)) for m in rows),
        nan_rescales=sum(line.startswith(head) and "NaN at boost" in line
                         for line in lines),
        range_retries=sum(line.startswith(head + "retry range")
                          for line in lines),
        r_lo=int(split[0].group(1)), coupling=float(coupling[0].group(1)),
        repair_rounds=sum("residual repair round" in line for line in lines))


def dc_held_to_cusolver(A, ev, U, what):
    """An eigh_dc result (ev, U) of A against cuSOLVER's eigenvalues of A,
    with tests/test_eigh_dc.py's tolerances, and its certificate: per-pair
    residuals below DC_RESID * max|ev| and max |U'U - I| below DC_ORTH.
    Returns (cuSOLVER's seconds, the errors)."""
    import torch

    from pygemma_tpu_torch.core.eigh_dc import _pair_residuals

    torch.cuda.synchronize()
    t0 = time.time()
    ev_ref = torch.linalg.eigvalsh(A)
    torch.cuda.synchronize()
    ref_s = time.time() - t0
    scale = float(ev_ref.abs().max())
    ev_err = float((ev.double() - ev_ref.double()).abs().max())
    ok = ((ev.double() - ev_ref.double()).abs()
          <= DC_EV_ATOL * scale + DC_EV_RTOL * ev_ref.double().abs())
    check(bool(ok.all()), f"{what}: eigenvalues off cuSOLVER's by "
                          f"{ev_err:.3e} (max|ev| {scale:.3e})")
    s, _, _ = _pair_residuals(A, U, ev)
    resid = float(s.max())
    eye = torch.matmul(U.T, U)
    eye.diagonal().sub_(1.0)
    orth = float(eye.abs().max())
    del eye, s
    check(resid < DC_RESID * scale and orth < DC_ORTH,
          f"{what}: certificate max resid {resid:.3e} (limit "
          f"{DC_RESID * scale:.3e}), max |U'U - I| {orth:.3e}")
    return ref_s, dict(max_ev_err=ev_err, max_ev_err_rel=ev_err / scale,
                       max_resid=resid, max_resid_rel=resid / scale,
                       max_orth=orth)


def phase_dc_large(pt, gk, large, ctx, tmp):
    """Phase 12a: eigh_backend="dc" on the large-GWAS path's 16,384 x 16,384
    Gram (``lowrank_top_basis``), held to cuSOLVER's, then a warm scan of
    the cohort on the dc basis held to phase 5's table.  The Gram is kept
    in ``tmp`` for phase 14b."""
    import numpy as np
    import torch

    from pygemma_tpu_torch import api
    from pygemma_tpu_torch.core import lowrank, solver

    lrk, cfg = ctx["lrk"], ctx["cfg"]
    real = lowrank.auto_eigendecompose
    seen = {}

    def spy(A, backend="auto", dtype=None, device="cuda"):
        out = real(A, backend=backend, dtype=dtype, device=device)
        seen.update(A=A, ev=out[0], V=out[1])
        return out

    api._EIGEN_DEV_CACHE.clear()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lowrank.auto_eigendecompose = spy
    try:
        t0 = time.time()
        (basis, stages), lines = dc_verbose(lambda: top_basis_stages(
            lambda: lowrank.lowrank_top_basis(lrk, "dc")))
        torch.cuda.synchronize()
        top_s = time.time() - t0
    finally:
        lowrank.auto_eigendecompose = real
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(basis.U_top).all()), "dc top basis not finite")
    del basis
    split = dc_split_stats(lines, PK_LARGE)
    cus_s, errs = dc_held_to_cusolver(seen["A"], seen["ev"], seen["V"],
                                      f"dc at n={PK_LARGE}")
    np.save(os.path.join(tmp, "gram.npy"), seen["A"].cpu().numpy())
    seen.clear()
    torch.cuda.empty_cache()
    print(f"dc: n={PK_LARGE} Gram: top basis {top_s:.2f} s (Gram eigh "
          f"{stages['gram_eigh_s']:.2f} s) against phase 5's cuSOLVER "
          f"{large['top_basis_s']:.2f} s (Gram eigh "
          f"{large['top_basis_stages']['gram_eigh_s']:.2f} s; eigvalsh here "
          f"{cus_s:.2f} s); depth-0 split: {split['sign_attempts']} sign "
          f"attempt(s), {split['sched_rows']} schedule rows + "
          f"{split['polish_rounds']} polish rounds, {split['range_retries']} "
          f"range retries, r_lo {split['r_lo']}, coupling "
          f"{split['coupling']:.2e}; peak device memory {peak / 2**30:.2f} "
          f"GiB; against cuSOLVER max |d ev| / max|ev| "
          f"{errs['max_ev_err_rel']:.3e}; certificate max resid / max|ev| "
          f"{errs['max_resid_rel']:.3e}, max |U'U - I| {errs['max_orth']:.3e}",
          flush=True)

    # the scan on the dc basis: the device cache keys a basis by kinship,
    # not by backend, so it is cleared first; the first call computes and
    # caches the dc basis, the second is the path's (warm) run
    dc_cfg = cfg.replace(eigh_backend="dc")
    api._EIGEN_DEV_CACHE.clear()
    t0 = time.time()
    pt.pygemma(ctx["y"], ctx["X"], ctx["W"], lrk, config=dc_cfg)
    cold_s = time.time() - t0
    reset_launches(gk, solver)
    t0 = time.time()
    df = pt.pygemma(ctx["y"], ctx["X"], ctx["W"], lrk, config=dc_cfg)
    scan_s = time.time() - t0
    launches = gk.fused_grams.launches
    reml, evals = reml_launches(solver, -(-P_LARGE // BLOCK_LARGE), "dc")
    rot_launches = rotate_launches(api._rotate_top.count, "dc")
    check(launches > 0, "the kernel was never launched on the dc path")
    d = lowrank_close(df, ctx["table"], "dc basis against cuSOLVER's")
    api._EIGEN_DEV_CACHE.clear()
    torch.cuda.empty_cache()
    print(f"dc: scan on the dc basis cold {cold_s:.2f} s, warm {scan_s:.2f} "
          f"s (phase 5: {large['scan_s']:.2f} s); kernel launches "
          f"{launches}; against phase 5's table max|dlog10 p|={d:.3e}",
          flush=True)
    return dict(n=PK_LARGE, top_basis_s=top_s, top_basis_stages=stages,
                phase5_top_basis_s=large["top_basis_s"],
                phase5_gram_eigh_s=large["top_basis_stages"]["gram_eigh_s"],
                eigvalsh_s=cus_s, split=split, peak_gib=peak / 2**30,
                **errs, cold_e2e_s=cold_s, scan_s=scan_s, launches=launches,
                rotate_launches=rot_launches,
                reml_launches=reml, evaluations=evals, vs_phase5_dlogp=d)


def phase_dc_dense(K, eigh_s):
    """Phase 12b: ``auto_eigendecompose(K, "dc")`` on phase 6's dense
    10,000 x 10,000 K (n <= 1.3 max_block: the edge-shave split), held to
    cuSOLVER's eigenvalues."""
    import numpy as np
    import torch

    from pygemma_tpu_torch.core.eigen import auto_eigendecompose

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    (ev, U), lines = dc_verbose(
        lambda: auto_eigendecompose(K, "dc", np.float32, "cuda"))
    torch.cuda.synchronize()
    dc_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    split = dc_split_stats(lines, N_FULL)
    Kd = torch.as_tensor(K, device="cuda")
    cus_s, errs = dc_held_to_cusolver(Kd, ev, U, f"dc at n={N_FULL}")
    del Kd, ev, U
    torch.cuda.empty_cache()
    print(f"dc: dense n={N_FULL} K: {dc_s:.2f} s against cuSOLVER's "
          f"{eigh_s:.2f} s (eigh) and {cus_s:.2f} s (eigvalsh); depth-0 "
          f"split: {split['sign_attempts']} sign attempt(s), "
          f"{split['sched_rows']} schedule rows + {split['polish_rounds']} "
          f"polish rounds, {split['range_retries']} range retries, r_lo "
          f"{split['r_lo']}; peak device memory {peak / 2**30:.2f} GiB; "
          f"against cuSOLVER max |d ev| / max|ev| "
          f"{errs['max_ev_err_rel']:.3e}; certificate max resid / max|ev| "
          f"{errs['max_resid_rel']:.3e}", flush=True)
    return dict(n=N_FULL, seconds=dc_s, cusolver_eigh_s=eigh_s,
                eigvalsh_s=cus_s, split=split, peak_gib=peak / 2**30, **errs)


def _run_script(path, argv):
    """A workload script's ``main()`` in this process with ``sys.argv``
    set (as tests/test_experiments.py runs them); returns its seconds."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "workload_" + Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = [str(path)] + argv
    t0 = time.time()
    try:
        mod.main()
    finally:
        sys.argv = old
    return time.time() - t0


def finite_table(path, sep="\t", share=0.99):
    """Rows of a written table whose p_wald is finite, checked against
    ``share``; returns the table's row count."""
    import numpy as np
    import pandas as pd

    df = pd.read_csv(path, sep=sep)
    fin = float(np.isfinite(df["p_wald"].to_numpy()).mean())
    check(len(df) > 0 and fin >= share,
          f"{path}: {len(df)} rows, finite p_wald {fin:.4f}")
    return len(df)


def phase_workloads(pt, oracle, tmp):
    """Phase 13: the torch workload scripts and the five scenarios of
    configs/run_config_torch.py on the card, in this process."""
    import numpy as np

    from pygemma_tpu_torch import api
    from pygemma_tpu_torch.io import rawbin

    exp = ROOT / "experiments"
    out = {}
    api._EIGEN_DEV_CACHE.clear()

    def run(name, path, argv, tables, sep="\t", share=0.99):
        secs = _run_script(path, argv)
        rows = [finite_table(t, sep, share) for t in tables]
        out[name] = dict(seconds=secs, rows=rows)
        print(f"workload: {name} {secs:.2f} s; tables "
              + ", ".join(f"{os.path.relpath(t, tmp)} ({r} rows)"
                          for t, r in zip(tables, rows)), flush=True)
        api._EIGEN_DEV_CACHE.clear()

    d = os.path.join(tmp, "animal")
    run("animal_gwas", exp / "animal_gwas" / "run_gwas_torch.py",
        ["--out-dir", d], [os.path.join(d, "assoc.tsv")])
    d = os.path.join(tmp, "case_control")
    run("case_control", exp / "case_control" / "run_torch.py",
        ["--out-dir", d], [os.path.join(d, "lmm.tsv")])
    d = os.path.join(tmp, "eqtl")
    os.environ.update(TASK_ID="0", TASK_COUNT="1")
    try:
        run("eqtl", exp / "eqtl" / "run_genes_torch.py",
            ["--out-dir", d, "--summary"],
            [os.path.join(d, f"gene{g}", f) for g in range(8)
             for f in ("lmm.tsv", "linreg.tsv")])
    finally:
        for k in ("TASK_ID", "TASK_COUNT"):
            os.environ.pop(k, None)
    d = os.path.join(tmp, "ukb_afr")
    run("ukb_afr", exp / "ukb_afr" / "run_chrom_torch.py",
        ["--out-dir", d, "--null-diagnostics"],
        [os.path.join(d, f"pygemma_results_chr{c}_pheno0.csv")
         for c in (20, 21)], sep=",", share=0.8)
    # large_gwas on pre-rotated rawbins of a small fixture
    y, G, W, K = oracle.simulate(n=LG_N, p=LG_P, c=3, seed=13)
    ev, U = np.linalg.eigh(K)
    d = os.path.join(tmp, "large_gwas")
    os.makedirs(d, exist_ok=True)
    for name, M in (("geno", U.T @ G), ("pheno", (U.T @ y)[:, None]),
                    ("covar", U.T @ W)):
        rawbin.write_rawbin(os.path.join(d, name), M.astype(np.float32))
    np.savetxt(os.path.join(d, "eig.txt"), np.maximum(ev, 0.0))
    run("large_gwas", exp / "large_gwas" / "run_pygemma_torch.py",
        ["--geno", os.path.join(d, "geno"), "--pheno",
         os.path.join(d, "pheno"), "--covar", os.path.join(d, "covar"),
         "--eigenvalues", os.path.join(d, "eig.txt"), "--out",
         os.path.join(d, "out.txt")], [os.path.join(d, "out.txt")])

    # the five scenarios at the scales of configs/run_config.py's docstring
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "run_config_torch", ROOT / "configs" / "run_config_torch.py")
    cfg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cfg)
    for name, scale in SCENARIO_SCALES.items():
        kw = ({"cache_dir": os.path.join(tmp, "ukb_synth_cache")}
              if name == "ukb_synth" else {})
        t0 = time.time()
        df = getattr(cfg, name)(scale, device="cuda", **kw)
        secs = time.time() - t0
        fin = float(np.isfinite(df["p_wald"].to_numpy()).mean())
        check(fin >= 0.99, f"scenario {name}: finite p_wald {fin:.4f}")
        out[f"scenario {name}"] = dict(seconds=secs, scale=scale,
                                       rows=len(df))
        print(f"workload: scenario {name} (scale {scale}) {secs:.2f} s; "
              f"{len(df)} rows, finite p_wald {fin:.4f}", flush=True)
        api._EIGEN_DEV_CACHE.clear()
    return out


def shard_rank(tmp: str) -> None:
    """Phase 14 in one rank of the group: (a) phase 6's dense run over
    ``make_mesh(snp=1, sample=2)``, (b) phase 12a's Gram through
    ``sharded_eigh_fn``; rank 0 holds each basis to cuSOLVER's.  Writes the
    rank's tables and numbers under ``tmp``."""
    import contextlib
    import hashlib
    import io
    import re

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    import pygemma_tpu_torch as pt
    from pygemma_tpu_torch.core import solver
    from pygemma_tpu_torch.ops import gram_kernel as gk
    from pygemma_tpu_torch.parallel.dist import sharded_eigh_fn
    from pygemma_tpu_torch.parallel.distributed import all_sum
    from pygemma_tpu_torch.parallel.mesh import make_mesh
    from pygemma_tpu_torch.parallel.slabs import Slabs

    mesh = make_mesh(snp=1, sample=SHARD_RANKS)
    rank = dist.get_rank()
    rec = dict(rank=rank, backend=dist.get_backend())

    def measured(fn):
        """fn() with eigh_dc's lines on, from a barrier: (its result, its
        lines, seconds, peak GiB, GiB sent by this rank)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        Slabs.sent_bytes = 0
        dist.barrier()
        t0 = time.time()
        out, lines = dc_verbose(fn)
        torch.cuda.synchronize()
        return (out, lines, time.time() - t0,
                torch.cuda.max_memory_allocated() / 2**30,
                Slabs.sent_bytes / 2**30)

    # (a) the dense path: the basis is split over the sample ranks
    y, X, W, K = make_full_width()
    cfg = pt.GwasConfig(snp_block=BLOCK)
    pt.api._EIGEN_DEV_CACHE.clear()
    log = io.StringIO()
    reset_launches(gk, solver)
    with contextlib.redirect_stderr(log):
        df, lines, e2e_s, peak, sent = measured(
            lambda: pt.pygemma(y, X, W, K, config=cfg, mesh=mesh, verbose=1))
    launches = gk.fused_grams.launches
    reml, evals = reml_launches(solver, None, f"sharded rank {rank}")
    # snp = 1: every rank rotates every block by the whole basis
    rot = rotate_launches(-(-P_FULL // BLOCK), f"sharded rank {rank}")
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(.+) - ([0-9.]+) s$", log.getvalue(), re.M)}
    rec["dense"] = dict(e2e_s=e2e_s, peak_gib=peak, sent_gib=sent,
                        launches=launches, stages=stages,
                        launches_all_ranks=all_sum(launches),
                        rotate_launches_all_ranks=all_sum(rot),
                        reml_launches_all_ranks=all_sum(reml),
                        evaluations_all_ranks=all_sum(evals))
    np.save(os.path.join(tmp, f"shard_rank{rank}.npy"),
            df.to_numpy(dtype=np.float64))
    if rank == 0:
        (ev, U), = pt.api._EIGEN_DEV_CACHE.values()
        rec["dense"]["split"] = dc_split_stats(lines, N_FULL)
        rec["dense"]["eigvalsh_s"], rec["dense"]["errs"] = \
            dc_held_to_cusolver(torch.as_tensor(K, device="cuda"), ev, U,
                                f"sample-sharded dc at n={N_FULL}")
        del ev, U
    pt.api._EIGEN_DEV_CACHE.clear()
    del df, X, K
    dist.barrier()

    # (b) phase 12a's Gram: each rank takes its rows of the file's matrix
    A = np.load(os.path.join(tmp, "gram.npy"), mmap_mode="r")
    (ev, U), lines, secs, peak, sent = measured(
        lambda: sharded_eigh_fn(mesh, cfg)(A))
    digest = hashlib.sha1(ev.cpu().numpy())
    digest.update(U.cpu().numpy())
    rec["gram"] = dict(seconds=secs, peak_gib=peak, sent_gib=sent,
                       sha1=digest.hexdigest())
    if rank == 0:
        rec["gram"]["split"] = dc_split_stats(lines, PK_LARGE)
        rec["gram"]["eigvalsh_s"], rec["gram"]["errs"] = \
            dc_held_to_cusolver(torch.as_tensor(np.asarray(A),
                                                device="cuda"), ev, U,
                                f"sample-sharded dc at n={PK_LARGE}")
    with open(os.path.join(tmp, f"shard_rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def phase_sharded_eigh(full, full_table, dc_large, dc_dense, tmp):
    """Phase 14: the sample-sharded eigendecomposition on two ranks sharing
    the card (gloo)."""
    import numpy as np

    from pygemma_tpu_torch.parallel.distributed import spawn

    t0 = time.time()
    spawn(shard_rank, SHARD_RANKS, (tmp,))
    wall = time.time() - t0
    recs = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(tmp, f"shard_rank{r}.json")) as f:
            recs.append(json.load(f))
    check(all(rec["backend"] == "gloo" for rec in recs),
          f"backends {[rec['backend'] for rec in recs]}, not gloo")
    tabs = [np.load(os.path.join(tmp, f"shard_rank{r}.npy"))
            for r in range(SHARD_RANKS)]
    for r in range(1, SHARD_RANKS):
        check(np.array_equal(tabs[0], tabs[r], equal_nan=True),
              f"phase 14a: rank {r}'s table differs from rank 0's")
        check(recs[r]["gram"]["sha1"] == recs[0]["gram"]["sha1"],
              f"phase 14b: rank {r}'s (ev, U) bytes differ from rank 0's")
    cols = list(full_table.columns)
    check(tabs[0].shape == full_table.shape,
          f"phase 14a table shape {tabs[0].shape}")
    a = tabs[0][:, cols.index("p_wald")]
    b = full_table["p_wald"].to_numpy()
    check(np.array_equal(np.isnan(a), np.isnan(b)),
          "phase 14a: NaN rows differ from phase 6's")
    ok = ~np.isnan(b)
    d = float(np.abs(np.log10(np.maximum(a[ok], 1e-300))
                     - np.log10(np.maximum(b[ok], 1e-300))).max())
    check(d < MESH_DLOGP, f"phase 14a vs phase 6: max |d log10 p| {d:.3e}")
    dense, gram = recs[0]["dense"], recs[0]["gram"]
    launches = dense["launches_all_ranks"]
    check(launches > 0, "the kernel was never launched on the sharded path")
    eigh_s = dense["stages"].get("eigendecomposition")
    check(eigh_s is not None, f"rank 0's stage log lacks the eigh: "
                              f"{dense['stages']}")

    def by_rank(part, key):
        return ", ".join(f"{rec[part][key]:.2f}" for rec in recs)

    print(f"sharded eigh: {SHARD_RANKS} ranks on one card (gloo). (a) dense "
          f"n={N_FULL}: eigh {eigh_s:.2f} s against phase 6's cuSOLVER "
          f"{full['eigh_s']:.2f} s and phase 12b's one-process dc "
          f"{dc_dense['seconds']:.2f} s; depth-0 r_lo "
          f"{dense['split']['r_lo']} ({dense['split']['sched_rows']} "
          f"schedule rows + {dense['split']['polish_rounds']} polish); "
          f"against cuSOLVER max |d ev| / max|ev| "
          f"{dense['errs']['max_ev_err_rel']:.3e}, certificate max resid / "
          f"max|ev| {dense['errs']['max_resid_rel']:.3e}, max |U'U - I| "
          f"{dense['errs']['max_orth']:.3e}; end to end {dense['e2e_s']:.2f} "
          f"s (phase 6: {full['e2e_s']:.2f} s); K1 launches {launches} over "
          f"the ranks; peak GiB by rank {by_rank('dense', 'peak_gib')} "
          f"(phase 12b one process {dc_dense['peak_gib']:.2f}); GiB sent by "
          f"rank {by_rank('dense', 'sent_gib')}; tables identical, vs phase "
          f"6 max|dlog10 p|={d:.3e}. (b) the {PK_LARGE} Gram: "
          f"{gram['seconds']:.2f} s against phase 12a's one-process dc "
          f"{dc_large['top_basis_stages']['gram_eigh_s']:.2f} s; depth-0 r_lo "
          f"{gram['split']['r_lo']}; against cuSOLVER "
          f"{gram['errs']['max_ev_err_rel']:.3e}, certificate "
          f"{gram['errs']['max_resid_rel']:.3e}, max |U'U - I| "
          f"{gram['errs']['max_orth']:.3e}; peak GiB by rank "
          f"{by_rank('gram', 'peak_gib')} (phase 12a one process "
          f"{dc_large['peak_gib']:.2f}); GiB sent by rank "
          f"{by_rank('gram', 'sent_gib')}; (ev, U) bytes identical; "
          f"{wall:.1f} s wall with the processes' start", flush=True)
    return dict(ranks=SHARD_RANKS, backend="gloo", launches=launches,
                reml_launches=dense["reml_launches_all_ranks"],
                rotate_launches=dense["rotate_launches_all_ranks"],
                evaluations=dense["evaluations_all_ranks"],
                dense=dict(eigh_s=eigh_s, phase6_eigh_s=full["eigh_s"],
                           phase12b_dc_s=dc_dense["seconds"],
                           vs_phase6_dlogp=d,
                           by_rank=[rec["dense"] for rec in recs]),
                gram=dict(phase12a_dc_s=dc_large["top_basis_stages"][
                    "gram_eigh_s"], phase12a_peak_gib=dc_large["peak_gib"],
                          by_rank=[rec["gram"] for rec in recs]),
                wall_s=wall)


def phase_full(pt, gk, solver):
    import numpy as np
    import torch

    t0 = time.time()
    y, X, W, K = make_full_width()
    print(f"full: data n={N_FULL} p={P_FULL} c={C_FULL} made in "
          f"{time.time() - t0:.1f} s", flush=True)
    Kd = torch.as_tensor(K, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    torch.linalg.eigh(Kd)
    torch.cuda.synchronize()
    eigh_s = time.time() - t0
    del Kd
    torch.cuda.empty_cache()

    cfg = pt.GwasConfig(snp_block=BLOCK)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(gk, solver)
    solver.host_value.count = 0
    t0 = time.time()
    df = pt.pygemma(y, X, W, K, config=cfg)  # the main path
    e2e_s = time.time() - t0
    launches = gk.fused_grams.launches
    reml, evals = reml_launches(solver, -(-P_FULL // BLOCK), "full")
    rot_launches = rotate_launches(-(-P_FULL // BLOCK), "full")
    syncs = solver.host_value.count
    peak = torch.cuda.max_memory_allocated()
    check(launches > 0, "the kernel was never launched on the main path")
    check(len(df) == P_FULL, "wrong number of table rows")
    finite = float(np.isfinite(df["p_wald"].to_numpy()).mean())
    check(finite > 0.99, f"only {finite:.4f} of p_wald is finite")

    t0 = time.time()
    df2 = pt.pygemma(y, X, W, K, config=cfg)  # eigenbasis cached: the scan
    scan_s = time.time() - t0
    check(np.array_equal(df2.to_numpy(), df.to_numpy(), equal_nan=True),
          "two runs of the same scan differ")
    n_blocks = -(-P_FULL // BLOCK)
    print(f"full: eigh {eigh_s:.2f} s (torch.linalg.eigh n={N_FULL} fp32), "
          f"end-to-end {e2e_s:.2f} s, warm scan {scan_s:.2f} s = "
          f"{P_FULL / scan_s:.0f} SNPs/s; kernel launches {launches} "
          f"({launches / n_blocks:.1f} per block of {BLOCK}); REML kernel "
          f"launches {reml} ({evals} evaluations); host syncs {syncs}; peak device memory {peak / 2**30:.2f} GiB; finite "
          f"p_wald {finite:.4f}", flush=True)

    # the first block again, kernel off: the kernel against its plain
    # version on the real path
    off = pt.pygemma(y, X[:, :BLOCK], W, K,
                     config=cfg.replace(use_fused_kernel=False))
    on = df.iloc[:BLOCK].reset_index(drop=True)
    d = table_close_dlogp(off, on, "p_wald", OFF_DLOGP)
    b_on, b_off = on["beta"].to_numpy(), off["beta"].to_numpy()
    ok = ~np.isnan(b_on)
    rel = np.abs(b_on[ok] - b_off[ok]) / np.abs(b_off[ok])
    tol = OFF_BETA_RTOL * np.abs(b_off[ok]) + 1e-6 * np.abs(b_off[ok]).max()
    check(bool(np.all(np.abs(b_on[ok] - b_off[ok]) <= tol)),
          f"beta kernel on vs off: max rel {rel.max():.3e}")
    print(f"full: first block kernel on vs off max|dlog10 p|={d:.3e} "
          f"beta max rel {rel.max():.3e} (median {np.median(rel):.3e})",
          flush=True)
    # 12b. the divide-and-conquer eigh of this K, before the profiler runs
    dc = phase_dc_dense(K, eigh_s)
    prof = profile_blocks(pt, gk, y, X[:, :PROFILE_BLOCKS * BLOCK], W, K, cfg,
                          BLOCK)
    print(json.dumps({"profile": prof}), flush=True)
    return dict(launches=launches, reml_launches=reml, evaluations=evals,
                rotate_launches=rot_launches, host_syncs=syncs, eigh_s=eigh_s,
                e2e_s=e2e_s, scan_s=scan_s, snps_per_s=P_FULL / scan_s,
                peak_gib=peak / 2**30, finite_p=finite), dc, df


def profile_blocks(pt, gk, y, X, W, K, cfg, block):
    """Where a warm scan's time goes: the wall time of the slice unprofiled,
    then the card's busy time (union of its kernel and copy intervals) and
    device time by kernel name under torch.profiler.  The idle share is
    1 - busy / unprofiled wall.  None when the profiler sees no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pt.pygemma(y, X, W, K, config=cfg)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.pygemma(y, X, W, K, config=cfg)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pt.pygemma(y, X, W, K, config=cfg)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print("profile: torch.profiler recorded no device activity",
              flush=True)
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for s_, e_ in spans[1:]:
        if s_ > hi:
            busy += hi - lo
            lo, hi = s_, e_
        else:
            hi = max(hi, e_)
    busy += hi - lo
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    k1_us = sum(t for name, t in by_name.items()
                if any(k in name for k in gk.KERNEL_NAMES))
    k1_launches = sum(gk.KERNEL_NAMES[0] in e.name for e in dev)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    blocks = X.shape[1] // block
    return dict(blocks=blocks, wall_ms=wall_us / 1e3,
                device_busy_ms=busy / 1e3, idle_share=1.0 - busy / wall_us,
                device_ops_per_block=len(dev) / blocks,
                k1_device_ms=k1_us / 1e3, k1_launches=k1_launches,
                k1_ms_per_launch=k1_us / 1e3 / max(k1_launches, 1),
                top_device_ms=[[name[:80], t / 1e3] for name, t in top])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import oracle  # numpy/scipy float64 reference, tests/oracle.py
    import pygemma_tpu_torch as pt
    from pygemma_tpu_torch.core import solver
    from pygemma_tpu_torch.device import check_matmul_precision
    from pygemma_tpu_torch.native import bed_native
    from pygemma_tpu_torch.ops import gram_kernel as gk

    # 1. environment
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(card, flush=True)
    check_matmul_precision()
    print("matmul: allow_tf32=False, float32 precision 'highest'", flush=True)

    # 2. build: the kernel (nvcc) and the host .bed decoder (g++) at once
    t0 = time.time()
    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        builds = [pool.submit(gk.build, True), pool.submit(bed_native.build)]
        for b in builds:
            b.result()
    gk._load()
    bed_native._load()
    print(f"build: {gk.SOURCE.relative_to(ROOT)} and "
          f"{bed_native.SOURCE.relative_to(ROOT)} in {time.time() - t0:.1f} s",
          flush=True)

    # 3. kernel parity: K1, then the REML kernel in every mode
    worst = phase_kernel_parity(gk)
    reml_worst, reml_ratio = phase_reml_parity()

    # 4. small end to end
    phase_small(pt, oracle)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 5. the large-GWAS path (implicit low-rank kinship, 2-bit cohort)
        large, ctx = phase_large(pt, gk, solver, tmp)

        # 9. the batched multi-phenotype scan on the same cohort
        multi = phase_multi(pt, gk, solver, ctx, tmp)

        # 10. the command line on a PLINK cohort
        cli, cli_files = phase_cli(tmp)

        # 11. (a) two ranks on phase 5's cohort; (b) the CLI with --mesh 2
        mesh = phase_mesh_large(ctx, large, ctx["prefix"], tmp)
        mesh_cli = phase_mesh_cli(tmp, cli_files)

        # 12a. the divide-and-conquer eigh of the cohort's 16,384 Gram and
        # a scan on its basis
        dc_large = phase_dc_large(pt, gk, large, ctx, tmp)

        # 6. full width, dense K (its profile comes after every timed
        # scan), and 12b. the divide-and-conquer eigh of its K
        full, dc_dense, full_table = phase_full(pt, gk, solver)

        # 14. the sample-sharded eigendecomposition on two ranks
        sharded = phase_sharded_eigh(full, full_table, dc_large, dc_dense,
                                     tmp)
        del full_table

        # where the large path's warm blocks spend their time
        large["profile"] = profile_blocks(
            pt, gk, ctx["y"], ctx["X"].cols(0, PROFILE_BLOCKS_LARGE
                                            * BLOCK_LARGE),
            ctx["W"], ctx["lrk"], ctx["cfg"], BLOCK_LARGE)
        print(json.dumps({"profile_large": large["profile"]}), flush=True)
        pt.api._EIGEN_DEV_CACHE.clear()
        del ctx

    # 7. kernel times: K1, the REML kernel, the rotation kernel
    rows, implicit_row = phase_kernel_times(gk)
    reml_rows = phase_reml_times()
    rot_rows = phase_rotate_times()

    # 11. (c) a one-rank NCCL mesh in this process
    mesh_nccl = phase_mesh_nccl(pt, oracle)

    # 13. the workload layer on the card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_work_") as tmp:
        workloads = phase_workloads(pt, oracle, tmp)

    # 8. records
    main_row = rows["kmax3"]
    paths = {  # the record's name of each main path -> its phase's record
        f"dense n={N_FULL} p={P_FULL}": full,
        f"implicit n={N_LARGE} p={P_LARGE} p_k={PK_LARGE}": large,
        f"implicit batched k={K_PHENOS} n={N_LARGE} p={P_LARGE} "
        f"p_k={PK_LARGE}": multi,
        f"mesh {MESH_RANKS} ranks implicit n={N_LARGE} p={P_LARGE} "
        f"p_k={PK_LARGE} (summed over ranks)": mesh,
        f"mesh {MESH_RANKS} ranks cli dense pheno 0 wald+lrt+score "
        f"n={N_FULL} p={P_FULL} (summed over ranks)": mesh_cli,
        f"implicit on the eigh_dc basis n={N_LARGE} p={P_LARGE} "
        f"p_k={PK_LARGE}": dc_large,
        f"sample mesh {SHARD_RANKS} ranks dense n={N_FULL} p={P_FULL} "
        f"on the sample-sharded eigh_dc basis (summed over ranks)": sharded}
    cli_paths = {f"cli dense k={K_PHENOS} n={N_FULL} p={P_FULL}": "run1",
                 f"cli dense pheno 0 wald+lrt+score n={N_FULL} p={P_FULL}":
                     "run2"}
    reml_by_path = {k: v["reml_launches"] for k, v in paths.items()}
    reml_by_path.update({k: cli[f"reml_launches_{r}"]
                         for k, r in cli_paths.items()})
    reml_main = reml_rows["dense.newton"]
    rot_main = rot_rows["r={} n={} B={}".format(*ROTATE_SHAPES[0][:3])]
    rot_by_path = {k: v["rotate_launches"] for k, v in paths.items()
                   if "rotate_launches" in v}
    record = {"kernels": [{
        "name": "fused_grams (k1_partials_kernel + k1_reduce_kernel)",
        "route": "cuda",
        "source": "pygemma_tpu_torch/csrc/gram_kernel.cu",
        "replaces": "pygemma_tpu/ops/gram_kernel.py:87",
        "launches": (full["launches"] + large["launches"]
                     + multi["launches"] + cli["launches_run1"]
                     + cli["launches_run2"] + mesh["launches"]
                     + mesh_cli["launches"] + dc_large["launches"]
                     + sharded["launches"]),
        "launches_by_path": {
            f"dense n={N_FULL} p={P_FULL}": full["launches"],
            f"implicit n={N_LARGE} p={P_LARGE} p_k={PK_LARGE}":
                large["launches"],
            f"implicit batched k={K_PHENOS} n={N_LARGE} p={P_LARGE} "
            f"p_k={PK_LARGE}": multi["launches"],
            f"cli dense k={K_PHENOS} n={N_FULL} p={P_FULL}":
                cli["launches_run1"],
            f"cli dense pheno 0 wald+lrt+score n={N_FULL} p={P_FULL}":
                cli["launches_run2"],
            f"mesh {MESH_RANKS} ranks implicit n={N_LARGE} p={P_LARGE} "
            f"p_k={PK_LARGE} (summed over ranks)": mesh["launches"],
            f"mesh {MESH_RANKS} ranks cli dense pheno 0 wald+lrt+score "
            f"n={N_FULL} p={P_FULL} (summed over ranks)":
                mesh_cli["launches"],
            f"implicit on the eigh_dc basis n={N_LARGE} p={P_LARGE} "
            f"p_k={PK_LARGE}": dc_large["launches"],
            f"sample mesh {SHARD_RANKS} ranks dense n={N_FULL} p={P_FULL} "
            f"on the sample-sharded eigh_dc basis (summed over ranks)":
                sharded["launches"]},
        "max_abs_err": worst,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "wall_ms": main_row["wall_ms"],
        "bound_fp32_ms": main_row["bound_fp32_ms"],
        "bound_fp32_by": main_row["bound_fp32_by"],
        "shape": f"n={N_FULL} B={BLOCK} c={C_FULL} R=1 kmax=3",
        "by_kmax": rows,
        "implicit_shape": dict(
            implicit_row,
            shape=f"n={PK_LARGE} B={BLOCK_LARGE} c={C_LARGE} R=1 kmax=3"),
    }, {
        "name": "reml_kernel",
        "route": "cuda",
        "source": "pygemma_tpu_torch/csrc/reml_kernel.cu",
        "replaces": None,  # the plain PyTorch algebra, no TPU kernel
        "launches": sum(reml_by_path.values()),
        "launches_by_path": reml_by_path,
        # the evaluations of each path that counts them (not the CLI's):
        # its launches less these are its Wald steps (blocks x phenotypes)
        "evaluations_by_path": {k: v["evaluations"]
                                for k, v in paths.items()
                                if "evaluations" in v},
        "max_abs_err": reml_worst,
        "max_err_over_tol": reml_ratio,
        "ms": reml_main["ms"],
        "plain_ms": reml_main["plain_ms"],
        "bound_ms": reml_main["bound_ms"],
        "bound_by": reml_main["bound_by"],
        "library_ms": None,
        "wall_ms": reml_main["wall_ms"],
        "shape": f"Newton step, n={N_FULL} B={BLOCK} c={C_FULL}",
        "by_case": reml_rows,
    }, {
        "name": "rotate_kernel",
        "route": "cuda",
        "source": "pygemma_tpu_torch/csrc/rotate_kernel.cu",
        "replaces": None,  # the JAX package's rotation is an XLA dot
        "launches": sum(rot_by_path.values()),
        # each equals the path's block rotations (checked where counted)
        "launches_by_path": rot_by_path,
        "max_rel_err": rot_main["max_rel_err"],
        "library_max_rel_err": rot_main["library_max_rel_err"],
        "ms": rot_main["ms"],
        # the plain version is torch.matmul: the library call itself
        "plain_ms": rot_main["library_ms"],
        "bound_ms": rot_main["bound_ms"],
        "bound_by": rot_main["bound_by"],
        "library_ms": rot_main["library_ms"],
        "shape": "r={} n={} B={}".format(*ROTATE_SHAPES[0][:3]),
        "by_shape": rot_rows,
    }]}
    print(json.dumps({"large_implicit": large}), flush=True)
    print(json.dumps({"full_width": full}), flush=True)
    print(json.dumps({"multi_phenotype": multi}), flush=True)
    print(json.dumps({"cli": cli}), flush=True)
    print(json.dumps({"mesh": {"large": mesh, "cli": mesh_cli,
                               "nccl": mesh_nccl}}), flush=True)
    print(json.dumps({"eigh_dc": {"large": dc_large, "dense": dc_dense}}),
          flush=True)
    print(json.dumps({"sharded_eigh": sharded}), flush=True)
    print(json.dumps({"workloads": workloads}), flush=True)
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
