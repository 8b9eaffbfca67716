"""K1's share of its roofline (%) over the scan's own launches.

From every ``k1`` span of call (a) of ``spans.py`` (device markers around
each launch): the sum over the launches of the least time the card could
take at that launch's shape (n, B, R, m, s, kmax, log h), the larger of the
bytes over HBM bandwidth and the operations over the fastest float32-grade
rate (the frozen ``work/k1.py``, ``peaks.json``), over the sum of the device
time between their markers.  The markers take in the gap between a launch
and its kernel where the card was idle, so the share errs low.  None
without device markers or peaks.
"""

from __future__ import annotations


def read(ctx):
    if ctx.peaks is None:
        return None
    from gwas_bench import spans, spec

    got = spans.plain(ctx)
    if got is None:
        return None
    k1 = spans.timed([s for s in got.spans if s.name == "k1"])
    if not k1:
        return None
    work = spec.work("k1")
    bound_s = 0.0
    for s in k1:
        a = s.attrs
        flops, nbytes = work.flops_and_bytes(a["n"], a["B"], a["R"], a["m"],
                                             a["s"], a["kmax"],
                                             a["want_logh"])
        bound_s += max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                       flops / ctx.peaks["fp32_grade_flops_per_s"])
    return 100.0 * bound_s / (sum(s.device_ns for s in k1) / 1e9)
