"""The host's own milliseconds a block in the REML solver (ms): the
``reml`` spans of call (a) of ``spans.py`` (one block's lambda search and
Wald step for all its phenotypes), each net of the ``sync`` spans inside
it (the host waiting for the device), summed, over the ``block`` spans.
What is left is the host dispatching the solver's work."""


def read(ctx):
    from gwas_bench import spans

    got = spans.plain(ctx)
    if got is None or not got.blocks:
        return None
    total = sum(s.host_ns for s in got.spans if s.name == "reml")
    waits = sum(s.host_ns for s in spans.under(got.spans, "sync", "reml"))
    return (total - waits) / 1e6 / got.blocks
