"""Rank 0's host milliseconds in the table step of a multi-card scan (ms):
the ``table`` spans of call (a) of ``spans.py``, summed.  Under a mesh that
span holds the one all_gather of every block's shares over the ranks, the
wait for the slowest rank with it, and the table's assembly.  None in a
one-card cell or without the span recorder."""


def read(ctx):
    if ctx.group is None:
        return None
    from gwas_bench import spans

    got = spans.plain(ctx)
    if got is None:
        return None
    tables = [s for s in got.spans if s.name == "table"]
    return sum(s.host_ns for s in tables) / 1e6 if tables else None
