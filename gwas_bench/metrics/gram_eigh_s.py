"""Device seconds of the eigendecomposition of a low-rank kinship's Gram
(s): the device time between the markers of the ``lowrank.gram_eigh``
spans of call (a) of ``spans.py`` (the p_k x p_k eigh inside the top
basis), summed.  None when call (a) computed no top basis (a warm basis, a
dense kinship) or without device markers."""


def read(ctx):
    from gwas_bench import spans

    got = spans.plain(ctx)
    if got is None:
        return None
    eig = spans.timed([s for s in got.spans if s.name == "lowrank.gram_eigh"])
    return sum(s.device_ns for s in eig) / 1e9 if eig else None
