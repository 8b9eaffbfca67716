"""Prefetching host->device SNP-block streaming for in-memory genotypes.

The goal is to overlap the host-side slice/pad/copy of block b+1 with device
compute on block b, so the association scan never stalls on PCIe.  On a
CUDA device each block is sliced into a pinned host buffer by a worker
thread and copied on a side stream; the consumer's stream waits on the
copy's event before it touches the block.  On the CPU a block is a padded
slice (pinned memory needs CUDA).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from collections import deque
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


class SnpBlockStreamer:
    """Iterate (start, stop, device_block) with ``depth`` blocks in flight.

    ``X`` is an (n, p) ndarray (or anything ``np.asarray`` slices by
    column); blocks are padded with zero columns to ``block``.
    """

    def __init__(self, X, block: int, dtype=np.float32, device="cpu",
                 depth: Optional[int] = None):
        self.X = X
        self.block = block
        self.dtype = np.dtype(dtype)
        self.device = torch.device(device)
        self.p = X.shape[1]
        # prefetch depth: how many blocks are sliced/shipped ahead of the
        # consumer (env override for measurements)
        self.depth = max(1, int(
            depth if depth is not None
            else os.environ.get("PYGEMMA_TPU_PREFETCH", "2")))
        self._cuda = self.device.type == "cuda"
        self._pinned = []  # ring of pinned host buffers (CUDA only)
        self._events = []  # copy-done event per pinned buffer
        self._side = None

    def _host_block(self, start: int, stop: int, out: np.ndarray) -> None:
        m = stop - start
        out[:, :m] = self.X[:, start:stop]
        out[:, m:] = 0

    def _fetch(self, k: int, start: int):
        stop = min(start + self.block, self.p)
        n = self.X.shape[0]
        if not self._cuda:
            xb = np.zeros((n, self.block), self.dtype)
            self._host_block(start, stop, xb)
            return start, stop, torch.from_numpy(xb).to(self.device), None
        slot = k % len(self._pinned)
        buf = self._pinned[slot]
        # the copy that last read this buffer must be done before reuse
        self._events[slot].synchronize()
        self._host_block(start, stop, buf.numpy())
        with torch.cuda.stream(self._side):
            xb = buf.to(self.device, non_blocking=True)
            self._events[slot].record(self._side)
        return start, stop, xb, self._events[slot]

    def __iter__(self) -> Iterator[Tuple[int, int, torch.Tensor]]:
        starts = list(range(0, self.p, self.block))
        if not starts:
            return
        if self._cuda:
            n = self.X.shape[0]
            nbuf = self.depth + 1
            torch_dtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
            self._side = torch.cuda.Stream(self.device)
            self._pinned = [torch.empty((n, self.block), dtype=torch_dtype,
                                        pin_memory=True)
                            for _ in range(nbuf)]
            self._events = [torch.cuda.Event() for _ in range(nbuf)]
            for ev in self._events:
                ev.record(self._side)  # "done" before the first use
        consumer = (torch.cuda.current_stream(self.device) if self._cuda
                    else None)
        # one worker thread keeps host slicing serial; up to ``depth``
        # blocks ride ahead of the consumer
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            pending = deque()
            for k, s in enumerate(starts):
                pending.append(pool.submit(self._fetch, k, s))
                if len(pending) <= self.depth and k + 1 < len(starts):
                    continue
                yield self._ready(pending.popleft().result(), consumer)
            while pending:
                yield self._ready(pending.popleft().result(), consumer)

    @staticmethod
    def _ready(item, consumer):
        start, stop, xb, event = item
        if event is not None:
            consumer.wait_event(event)
            # the block was allocated on the side stream: keep the caching
            # allocator from reusing it before the consumer is done with it
            xb.record_stream(consumer)
        return start, stop, xb
