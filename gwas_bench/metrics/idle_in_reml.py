"""The share of the device's idle time spent inside the REML solver (%):
in call (b) of ``spans.py`` (under torch.profiler, spans without device
markers), the idle gaps between the device's kernels, copies and sets whose
middle lies inside a ``reml`` span of the calling thread, over all the
call's idle time.  None when the trace holds no device operation."""


def read(ctx):
    from gwas_bench import spans

    got = spans.profiled(ctx)
    if got is None or not got.idle_s:
        return None
    return 100.0 * got.idle_in_reml_s / got.idle_s
