#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``pygemma_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. environment: torch/CUDA versions, the card's name and power limit, and
   the full-float32 matmul settings the scan requires;
2. build: the hand-written kernel (``csrc/gram_kernel.cu``) with nvcc;
3. kernel parity: ``fused_grams`` through the kernel against its plain
   PyTorch version on the card at the main path's shapes;
4. small end to end: the port's ``pygemma`` on the card in float32 against
   the float64 NumPy oracle (tests/oracle.py), and in float64 against the
   port on the CPU;
5. full width: n = 10,000 samples, p = 50,000 SNPs, c = 3, REML Wald, with
   the kernel's launches and the solver's host syncs counted over the run,
   then the first block again with the kernel off, and a torch.profiler
   breakdown of four warm blocks (device busy time, time by kernel);
6. kernel times at the main shape: the kernel's device time per call
   (torch.profiler), its wall time per call and the plain version's wall
   time.  They come after phase 5 because the profiler, once run, slows
   every later launch from the host;
7. one JSON line per kernel, and a last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# main-path shape of the kernel: one SNP block of the full-width run
N_FULL, P_FULL, C_FULL, BLOCK = 10_000, 50_000, 3, 2_048
PROFILE_BLOCKS = 4  # warm blocks traced by torch.profiler
PARITY_RTOL = PARITY_ATOL = 1e-4  # beyond the float32 plain version's error
SMALL_DLOGP = 0.05  # the JAX package's float32 contract vs the oracle
CARD_CPU_RTOL = 1e-6  # float64 card vs float64 CPU
OFF_DLOGP, OFF_BETA_RTOL = 0.05, 5e-3  # kernel on vs off at full width


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


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
    worst = 0.0
    for n, B, c, R, kmax, logh in cases:
        label = f"n={n} B={B} c={c} R={R} kmax={kmax} logh={int(logh)}"
        worst = max(worst, held_to_plain(gk, kernel_inputs(n, B, c, R, gen),
                                         kmax, logh, label))
    return worst


def phase_kernel_times(gk):
    """K1's times at the main shape, by kmax; the kmax 3 row is the
    record's."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    s = C_FULL + 1
    m = s * (s + 1) // 2
    args = kernel_inputs(N_FULL, BLOCK, C_FULL, 1, gen)
    rows = {}
    for kmax, logh in ((1, True), (2, False), (3, False), (1, False)):
        call = lambda: gk.fused_grams(*args, kmax, logh)  # noqa: E731
        ms = device_ms(call, gk.KERNEL_NAMES)
        wall_ms = cuda_ms(call)
        plain_ms = cuda_ms(lambda: gk.fused_grams_reference(*args, kmax, logh))
        fp32, tf32, nbytes = gk.tensor_core_work(N_FULL, BLOCK, 1, m, s, kmax,
                                                 logh)
        b_ms, b_by = gk.bound_ms(fp32, nbytes, tf32_flops=tf32)
        b1_ms, b1_by = gk.bound_ms(*gk.flops_and_bytes(N_FULL, BLOCK, 1, m, s,
                                                       kmax, logh))
        rows[f"kmax{kmax}{'_logh' if logh else ''}"] = dict(
            ms=ms, wall_ms=wall_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bound_fp32_ms=b1_ms, bound_fp32_by=b1_by)
        print(f"time n={N_FULL} B={BLOCK} c={C_FULL} kmax={kmax} "
              f"logh={int(logh)}: kernel {ms:.4f} ms device ({wall_ms:.4f} "
              f"ms wall), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; FP32 pipes "
              f"{b1_ms:.4f} ms, {b1_by})", flush=True)
    return rows


def table_close_dlogp(got, ref, col, limit):
    import numpy as np

    a, b = got[col].to_numpy(), ref[col].to_numpy()
    check(np.array_equal(np.isnan(a), np.isnan(b)), f"{col}: NaN rows differ")
    ok = ~np.isnan(b)
    d = float(np.max(np.abs(np.log10(a[ok]) - np.log10(b[ok]))))
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
    gk.fused_grams.launches = 0
    solver.host_value.count = 0
    t0 = time.time()
    df = pt.pygemma(y, X, W, K, config=cfg)  # the main path
    e2e_s = time.time() - t0
    launches = gk.fused_grams.launches
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
          f"({launches / n_blocks:.1f} per block of {BLOCK}); host syncs "
          f"{syncs}; peak device memory {peak / 2**30:.2f} GiB; finite "
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
    prof = profile_blocks(pt, gk, y, X[:, :PROFILE_BLOCKS * BLOCK], W, K, cfg)
    print(json.dumps({"profile": prof}), flush=True)
    return dict(launches=launches, host_syncs=syncs, eigh_s=eigh_s,
                e2e_s=e2e_s, scan_s=scan_s, snps_per_s=P_FULL / scan_s,
                peak_gib=peak / 2**30, finite_p=finite)


def profile_blocks(pt, gk, y, X, W, K, cfg):
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
    blocks = X.shape[1] // BLOCK
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
    from pygemma_tpu_torch import api
    from pygemma_tpu_torch.core import solver
    from pygemma_tpu_torch.ops import gram_kernel as gk

    # 1. environment
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(card, flush=True)
    api._check_matmul_precision()
    print("matmul: allow_tf32=False, float32 precision 'highest'", flush=True)

    # 2. build
    t0 = time.time()
    gk.build(verbose=True)
    gk._load()
    print(f"build: {gk.SOURCE.relative_to(ROOT)} in {time.time() - t0:.1f} s",
          flush=True)

    # 3. kernel parity
    worst = phase_kernel_parity(gk)

    # 4. small end to end
    phase_small(pt, oracle)

    # 5. full width
    full = phase_full(pt, gk, solver)

    # 6. kernel times
    rows = phase_kernel_times(gk)

    # 7. records
    main_row = rows["kmax3"]
    record = {"kernels": [{
        "name": "fused_grams (k1_partials_kernel + k1_reduce_kernel)",
        "route": "cuda",
        "source": "pygemma_tpu_torch/csrc/gram_kernel.cu",
        "replaces": "pygemma_tpu/ops/gram_kernel.py:87",
        "launches": full["launches"],
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
    }]}
    print(json.dumps({"full_width": full}), flush=True)
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
