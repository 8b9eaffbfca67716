"""Device seconds of the program's own eigendecomposition (s): the device
time between the markers of the ``eigen`` span of call (a) of
``spans.py`` that computed the basis (in the study cell, whose two
cohorts take turns, every call computes it).  None when no call computed
one or without device markers."""


def read(ctx):
    from gwas_bench import spans

    got = spans.plain(ctx)
    if got is None:
        return None
    eig = spans.timed([s for s in got.spans if s.name == "eigen"
                       and s.attrs.get("source") == "computed"])
    return sum(s.device_ns for s in eig) / 1e9 if eig else None
