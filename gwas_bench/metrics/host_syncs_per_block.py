"""Host syncs per SNP block (syncs): the change of the program's own
counter ``core/solver.py::host_value.count`` over the traced window, over
the SNP blocks it streamed."""


def read(ctx):
    return ctx.counters["host_syncs"] / ctx.blocks
