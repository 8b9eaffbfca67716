"""How far the ranks of a multi-card scan fall apart (%): in call (a) of
``spans.py``, each rank's host time in its ``scan`` span net of the
``table`` span inside it (whose gather waits for the slowest rank, so every
rank's scan ends together), gathered to rank 0: (the slowest rank's - the
fastest's) / the fastest's.  Every rank runs this reader.  None in a
one-card cell or without the span recorder."""


def read(ctx):
    if ctx.group is None:
        return None
    from gwas_bench import spans

    got = spans.plain(ctx)
    if got is None:
        return None
    scans = [s for s in got.spans if s.name == "scan"]
    tables = spans.under(got.spans, "table", "scan")
    own = (sum(s.host_ns for s in scans) - sum(s.host_ns for s in tables)
           if scans else None)
    every = ctx.group.gather(own)  # a collective: on every rank, always
    if any(v is None or v <= 0 for v in every):
        return None
    return 100.0 * (max(every) - min(every)) / min(every)
