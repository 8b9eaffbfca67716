"""The rotation's share of its roofline (%), on the scan's own rotations.

From the program's ``rotate`` spans inside its ``block`` spans in call (a)
of ``spans.py`` (device markers on): the sum over them of the least time
the card could take, the larger of the bytes over HBM bandwidth and the
operations over the fastest float32-grade rate (``work/rotate.py``,
``peaks.json``), over the sum of the device time between their markers.
None without device markers or peaks.
"""

from __future__ import annotations


def read(ctx):
    if ctx.peaks is None:
        return None
    from gwas_bench import spans, spec

    got = spans.plain(ctx)
    if got is None:
        return None
    rot = spans.timed(spans.under(got.spans, "rotate", "block"))
    if not rot:
        return None
    work = spec.work("rotate")
    bound_s = 0.0
    for s in rot:
        flops, nbytes = work.flops_and_bytes(s.attrs["r"], s.attrs["n"],
                                             s.attrs["B"])
        bound_s += max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                       flops / ctx.peaks["fp32_grade_flops_per_s"])
    return 100.0 * bound_s / (sum(s.device_ns for s in rot) / 1e9)
