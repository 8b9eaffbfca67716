"""The top basis's products' share of their roofline (%).

From the program's ``lowrank.stream_gram`` and ``lowrank.top_basis`` spans
of call (a) of ``spans.py`` (device markers on): the sum over them of the
least time the card could take, the larger of the bytes over HBM bandwidth
and the operations over the fastest float32-grade rate (the frozen
``work/lowrank.py`` at the configuration's n and p_k, ``peaks.json``),
over the sum of the device time between their markers.  The markers take
in the stream of the codes from the host, which the share shows.  None
for a dense kinship, when call (a) computed no top basis, or without
device markers or peaks.
"""

from __future__ import annotations

STAGES = {"lowrank.stream_gram": "gram", "lowrank.top_basis": "top_basis"}


def read(ctx):
    cfg = ctx.cell.config
    if ctx.peaks is None or cfg["kinship"]["type"] != "lowrank_grm":
        return None
    from gwas_bench import spans, spec

    got = spans.plain(ctx)
    if got is None:
        return None
    stages = spans.timed([s for s in got.spans if s.name in STAGES])
    if not stages:
        return None
    work = spec.work("lowrank")
    bound_s = 0.0
    for s in stages:
        flops, nbytes = getattr(work, STAGES[s.name])(cfg["n"],
                                                      cfg["kinship"]["snps"])
        bound_s += max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                       flops / ctx.peaks["fp32_grade_flops_per_s"])
    return 100.0 * bound_s / (sum(s.device_ns for s in stages) / 1e9)
