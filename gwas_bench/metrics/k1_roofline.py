"""K1's share of its roofline (%), at the cell's launch shape.

K1 alone, called through the program's ``fused_grams`` on seeded inputs at
the cell's shape: the kernel's n is the kinship's explicit directions (the
16,384 kinship SNPs of a low-rank K, all n samples of a dense one), B the
cell's SNP block, c + 1 shared columns, kmax 3, one lambda slot.  Its device
time per launch (partials + reduce) comes from torch.profiler.  The bound
is the larger of the bytes over HBM bandwidth and the operations over the
fastest float32-grade rate (3xTF32: the TF32 peak over three passes), both
from ``work/k1.py`` and ``peaks.json``, so no correct implementation reads
over 100%.
"""

from __future__ import annotations

R, KMAX, REPS = 1, 3, 30


def read(ctx):
    if ctx.device.type != "cuda" or ctx.peaks is None:
        return None
    import torch

    from pygemma_tpu_torch.core.grams import pair_products
    from pygemma_tpu_torch.ops import gram_kernel

    from gwas_bench import spec, trace

    work = spec.work("k1")

    cfg = ctx.cell.config
    kin = cfg["kinship"]
    n = kin["snps"] if kin["type"] == "lowrank_grm" else cfg["n"]
    B, s = cfg["snp_block"], cfg["c"] + 1
    gen = torch.Generator(device=ctx.device).manual_seed(11)

    def draw(*shape):
        return torch.randn(*shape, device=ctx.device, generator=gen)

    ev = torch.rand(n, device=ctx.device, generator=gen) * 5.0
    shared = draw(n, s)
    v = draw(n, B)
    lam = 10.0 ** (torch.rand(B, device=ctx.device, generator=gen) * 8 - 4)
    pairs = pair_products(shared)
    ms = trace.kernel_ms(
        lambda: gram_kernel.fused_grams(lam, ev, pairs, shared, v, KMAX),
        gram_kernel.KERNEL_NAMES, REPS)
    if ms is None:
        return None
    flops, nbytes = work.flops_and_bytes(n, B, R, pairs.shape[1], s, KMAX,
                                         False)
    bound_s = max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                  flops / ctx.peaks["fp32_grade_flops_per_s"])
    return 100.0 * bound_s / (ms / 1e3)
