"""Stage logging with wall-time banners.

Mirrors the reference's rich-console stage logs (lmm/lmm.py:144-163) but
degrades gracefully to plain logging when rich is unavailable.
"""

from __future__ import annotations

import contextlib
import logging
import time

try:  # rich is present in the reference's dependency set; optional here
    from rich.console import Console

    _console = Console()
except Exception:  # pragma: no cover
    _console = None

logger = logging.getLogger("pygemma_tpu_torch")


class StageLogger:
    def __init__(self, verbose: int = 0):
        self.verbose = verbose

    def log(self, msg: str) -> None:
        if self.verbose <= 0:
            return
        if _console is not None:
            _console.log(msg)
        else:
            logger.info(msg)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.time()
        try:
            yield
        finally:
            self.log(f"[green]{name} - {round(time.time() - start, 3)} s")

    def track(self, iterable, description: str = "", total=None):
        """Progress bar over an iterable (reference rich.progress.track SNP
        bar, lmm/lmm.py:395); plain pass-through when quiet."""
        if self.verbose <= 0:
            return iterable
        try:
            from rich.progress import track as _track

            return _track(iterable, description=description, total=total)
        except Exception:  # pragma: no cover
            return iterable
