#!/usr/bin/env python3
"""Where K1's time and precision go on the card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 k1_ablation.py

Each entry builds ``pygemma_tpu_torch/csrc/gram_kernel.cu`` with one of the
measurement switches listed at the top of that source (``-D K1_ABLATE_*``;
the entry ``full`` sets none) into ``pygemma_tpu_torch/_build/``, and times
it at the main path's shape (n = 10,000, B = 2,048, c = 3, R = 1) at kmax 1
and 3: device time per call from torch.profiler.

Entries whose sums must stay right (the kernel, and the same pipeline with
the products as FP32 FMAs) or must break chip_smoke.py's parity rule (one
TF32 pass, the unsplit operands) are held to that rule on three inputs:
the main shape at kmax 3, c = 10 with R = 2 at kmax 3, and a spectrum with
large eigenvalues with lambda over 1e-5..1e5.  ``approx_rcp``'s verdict is
printed, not held.  The other entries are timings whose sums are wrong by
design.

Then the kernel's error against float64 at several lengths of the
sample-axis split.  The sums of one split are one chain of tensor-core
accumulations, so an error that grows with the split's length is the
accumulation's.

Last, the same split lengths end to end: the first block of chip_smoke.py's
large-GWAS path (implicit low-rank kinship, p_k = 16,384 rows, blocks of
8,192) scanned with the plan's split capped at each length, its lambda and
beta against a float64 scan of the block beside the plain version's, and
the kernel's device time at that shape.  Reported, not held.

Prints one line per entry and kmax, one per parity verdict and one per
split length, and the card's name and power limit.  Exits non-zero when a
verdict is not the expected one.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# name: (measurement switch, expected parity verdict: True must pass, False
# must fail, "report" printed only, None not checked)
ABLATIONS = {
    "full": (None, True),
    "stream_only": ("K1_ABLATE_STREAM_ONLY", None),
    "no_products": ("K1_ABLATE_NO_PRODUCTS", None),
    "approx_rcp": ("K1_ABLATE_APPROX_RCP", "report"),
    "one_pass": ("K1_ABLATE_ONE_PASS", False),
    "no_split": ("K1_ABLATE_NO_SPLIT", False),
    "fp32_products": ("K1_ABLATE_FP32_PRODUCTS", True),
}
SPANS = (32, 128, 512, 2048)  # samples per split, beside the plan's own
CAPS = (1024, 512, 256, 128)  # split caps of the end-to-end sweep


def run(gk, lib, args, kmax, logh, span=None):
    """``fused_grams``'s result through the kernel of ``lib``."""
    import torch

    lam, ev, pairs, shared, v = args
    lam2 = (lam[:, None] if lam.ndim == 1 else lam).contiguous()
    out = gk.launch(lib, lam2, ev, pairs, shared, v, kmax, logh, span=span)
    torch.cuda.synchronize()
    res = gk._split_rows(out, pairs.shape[1], shared.shape[1], kmax, logh)
    return tuple(t.squeeze(1) for t in res) if lam.ndim == 1 else res


def parity_inputs(cs, gen):
    """label -> (kernel inputs, kmax) of the parity verdicts."""
    import torch

    main = cs.kernel_inputs(cs.N_FULL, cs.BLOCK, cs.C_FULL, 1, gen)
    _, _, pairs, shared, v = main
    n, B = v.shape
    ev = torch.cat([torch.rand(n - 50, device="cuda", generator=gen) * 2.0,
                    10.0 ** (2.0 + 2.0 * torch.rand(50, device="cuda",
                                                    generator=gen))])
    lam = torch.logspace(-5, 5, B, device="cuda")
    return {
        "main c=3 R=1": (main, 3),
        "c=10 R=2": (cs.kernel_inputs(cs.N_FULL, cs.BLOCK, 10, 2, gen), 3),
        "large ev, lam 1e-5..1e5": ((lam, ev, pairs, shared, v), 3),
    }


def lowrank_split_sweep(cs, gk):
    """Lambda's and beta's error on the implicit path's first block, and
    K1's device time there, with the plan's split capped at each of CAPS."""
    import tempfile

    import numpy as np
    import torch

    import pygemma_tpu_torch as pt

    def errors(t, ref):
        out = []
        for col in ("lambda", "beta"):
            a, r = t[col].to_numpy(), ref[col].to_numpy()
            ok = ~np.isnan(r)
            e = np.abs(a[ok] - r[ok])
            out.append(f"{col} max abs {e.max():.3e} median rel "
                       f"{np.median(e / np.abs(r[ok])):.3e}")
        return "; ".join(out)

    gen = torch.Generator(device="cuda").manual_seed(3)
    args = cs.kernel_inputs(cs.PK_LARGE, cs.BLOCK_LARGE, cs.C_LARGE, 1, gen)
    with tempfile.TemporaryDirectory(prefix="k1_ablation_") as tmp:
        _, X, y, W, lrk, cfg = cs.large_inputs(tmp)
        first = X.cols(0, cs.BLOCK_LARGE)
        ref = pt.pygemma(y, X[:, :cs.BLOCK_LARGE].astype(np.float64), W, lrk,
                         config=cfg.replace(dtype="float64"))
        off = pt.pygemma(y, first, W, lrk,
                         config=cfg.replace(use_fused_kernel=False))
        print(f"implicit first block, plain float32 vs float64: "
              f"{errors(off, ref)}", flush=True)
        plan_cap = gk._MAX_SPAN
        try:
            for cap in CAPS:
                gk._MAX_SPAN = cap
                on = pt.pygemma(y, first, W, lrk, config=cfg)
                ms = cs.device_ms(lambda: gk.fused_grams(*args, 3, False),
                                  gk.KERNEL_NAMES)
                print(f"implicit first block, split cap {cap}: kernel vs "
                      f"float64 {errors(on, ref)}; K1 n={cs.PK_LARGE} "
                      f"B={cs.BLOCK_LARGE} kmax=3 {ms:.4f} ms device",
                      flush=True)
        finally:
            gk._MAX_SPAN = plan_cap


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_ablation: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pygemma_tpu_torch.ops import gram_kernel as gk

    print(cs.card_line(), flush=True)
    with ThreadPoolExecutor(len(ABLATIONS)) as pool:  # one nvcc each
        paths = dict(zip(ABLATIONS, pool.map(
            lambda sw: gk.build(defines=(sw,) if sw else ()),
            (sw for sw, _ in ABLATIONS.values()))))
    libs = {name: gk.bind(path) for name, path in paths.items()}

    gen = torch.Generator(device="cuda").manual_seed(1)
    timing = cs.kernel_inputs(cs.N_FULL, cs.BLOCK, cs.C_FULL, 1, gen)
    for name, lib in libs.items():
        for kmax in (1, 3):
            ms = cs.device_ms(lambda: run(gk, lib, timing, kmax, False),
                              gk.KERNEL_NAMES)
            print(f"ablation {name} kmax={kmax}: {ms:.4f} ms device",
                  flush=True)

    cases = parity_inputs(cs, gen)
    wrong = []
    for name, (_, expect) in ABLATIONS.items():
        if expect is None:
            continue
        verdicts = []
        for label, (args, kmax) in cases.items():
            ok, err, rel, rel_plain = cs.parity(
                gk, run(gk, libs[name], args, kmax, True), args, kmax, True)
            verdicts.append(ok)
            print(f"parity {name} [{label}]: {'meets' if ok else 'breaks'} "
                  f"the rule; max|got-f64|/max|f64| {rel:.3e} (plain "
                  f"float32 {rel_plain:.3e}), max|got-plain| {err:.3e}",
                  flush=True)
        if expect is True and not all(verdicts):
            wrong.append(f"{name} breaks the parity rule")
        if expect is False and all(verdicts):
            wrong.append(f"{name} meets the parity rule on every input")

    for label in ("main c=3 R=1", "c=10 R=2"):
        args, kmax = cases[label]
        for span in SPANS + (None,):
            for name in ("full", "fp32_products"):
                _, _, rel, rel_plain = cs.parity(
                    gk, run(gk, libs[name], args, kmax, True, span=span),
                    args, kmax, True)
                print(f"span {span or 'plan'} {name} [{label}]: "
                      f"max|got-f64|/max|f64| {rel:.3e} (plain float32 "
                      f"{rel_plain:.3e})", flush=True)

    lowrank_split_sweep(cs, gk)

    for msg in wrong:
        print(f"k1_ablation FAILED: {msg}", flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
