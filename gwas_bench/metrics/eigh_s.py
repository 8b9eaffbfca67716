"""Seconds of the program's eigendecomposition of a dense kinship
(``core/eigen.py::auto_eigendecompose``, cuSOLVER), host clock with a
device synchronize around it, on each of the cell's kinships; the mean.
None for a low-rank kinship."""

import time


def read(ctx):
    if ctx.device.type != "cuda" or any(c.K is None for c in ctx.cohorts):
        return None
    import numpy as np
    import torch

    from pygemma_tpu_torch.core.eigen import auto_eigendecompose

    times = []
    for co in ctx.cohorts:
        torch.cuda.synchronize(ctx.device)
        t0 = time.perf_counter()
        ev, U = auto_eigendecompose(co.K, "auto", np.float32, ctx.device)
        torch.cuda.synchronize(ctx.device)
        times.append(time.perf_counter() - t0)
        del ev, U
    return sum(times) / len(times)
