"""Device milliseconds a block of the genotype codes' dequantization (ms):
the device time between the markers of the ``dequant`` spans inside the
``scan`` spans of call (a) of ``spans.py``, summed, over its ``block``
spans.  None without device markers or coded genotypes."""


def read(ctx):
    from gwas_bench import spans

    got = spans.plain(ctx)
    if got is None or not got.blocks:
        return None
    deq = spans.timed(spans.under(got.spans, "dequant", "scan"))
    if not deq:
        return None
    return sum(s.device_ns for s in deq) / 1e6 / got.blocks
