"""Host milliseconds a block that the scan waited for its genotype block
(ms): the ``stream.wait`` spans inside the ``scan`` spans of call (a) of
``spans.py``, summed, over its ``block`` spans."""


def read(ctx):
    from gwas_bench import spans

    got = spans.plain(ctx)
    if got is None or not got.blocks:
        return None
    waits = spans.under(got.spans, "stream.wait", "scan")
    return sum(s.host_ns for s in waits) / 1e6 / got.blocks
