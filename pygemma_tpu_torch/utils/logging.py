"""Stage logging with wall-time lines.

Mirrors the reference's stage logs (lmm/lmm.py:144-163): with ``verbose``
on, each stage ends with one plain line on stderr, ``<stage> - <seconds> s``,
which the command line's users and scripts can read; the SNP loop shows a
rich progress bar when rich is installed.  A stage given a span name is
also that span of utils/profiling.py.  In a multi-GPU run only rank 0
logs: the other ranks run the same stages.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Optional

import torch.distributed as dist

from . import profiling


def _quiet_rank() -> bool:
    """Whether this process is a rank other than 0 of a process group."""
    return dist.is_initialized() and dist.get_rank() != 0


class StageLogger:
    def __init__(self, verbose: int = 0):
        self.verbose = verbose

    def _on(self) -> bool:
        return self.verbose > 0 and not _quiet_rank()

    def log(self, msg: str) -> None:
        if self._on():
            print(msg, file=sys.stderr, flush=True)

    @contextlib.contextmanager
    def stage(self, name: str, span: Optional[str] = None):
        """Log the body's wall time as ``name``; with ``span``, record the
        body as that span too."""
        start = time.time()
        with profiling.span(span):
            try:
                yield
            finally:
                self.log(f"{name} - {time.time() - start:.3f} s")

    def track(self, iterable, description: str = "", total=None):
        """Progress bar over an iterable (reference rich.progress.track SNP
        bar, lmm/lmm.py:395); plain pass-through when quiet or without
        rich."""
        if not self._on():
            return iterable
        try:
            from rich.progress import track as _track
        except ImportError:
            return iterable
        return _track(iterable, description=description, total=total)
