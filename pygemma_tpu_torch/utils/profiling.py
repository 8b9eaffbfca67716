"""Profiling hooks: torch.profiler device traces + host cProfile.

Reference equivalents: cProfile dumps around single kernel calls
(tests/profile_pygemma.py:242-249) and whole-run cProfile / pyinstrument
recipes (tests/profile.sh:14-21).  On the card the useful artifact is a
torch.profiler trace with the CUDA activity (a Chrome trace, viewable in
Perfetto or chrome://tracing); host cProfile is kept for the host-side
overhead.
"""

from __future__ import annotations

import contextlib
import cProfile
import io
import os
import pstats
import tempfile
import time
from typing import Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Trace a block of work with torch.profiler and write a Chrome trace,
    ``<log_dir>/trace.json`` (by default under the temporary directory).
    The host's activity is always traced, the card's when CUDA is
    available.  Yields the trace's path."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "pygemma_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def host_profile(sort: str = "cumtime", top: int = 30, stream=None):
    """cProfile a host-side block and print the hottest entries."""
    pr = cProfile.Profile()
    pr.enable()
    try:
        yield pr
    finally:
        pr.disable()
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats(sort).print_stats(top)
        print(s.getvalue(), file=stream)


class StageTimer:
    """Accumulate named wall-time buckets (reference's rich stage timings,
    lmm/lmm.py:144-163, as a reusable object)."""

    def __init__(self):
        self.totals = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.2f}s" for k, v in self.totals.items())
