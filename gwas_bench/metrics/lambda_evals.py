"""Lambda evaluations a block (evals): the change of the program's own
counter ``core/solver.py::evaluate.count`` over call (a) of ``spans.py``,
over its ``block`` spans.  A cohort whose lambda search takes more rounds
reads higher."""


def read(ctx):
    from gwas_bench import spans

    got = spans.plain(ctx)
    if got is None or not got.blocks or got.counters["evaluations"] is None:
        return None
    return got.counters["evaluations"] / got.blocks
