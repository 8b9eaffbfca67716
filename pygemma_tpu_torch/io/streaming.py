"""Prefetching host->device SNP-block streaming.

The goal is to overlap the host-side slice/pad/copy of block b+1 with device
compute on block b, so the association scan never stalls on PCIe.  Three
kinds of genotype matrix stream:

* an (n, p) float ndarray (or anything ``np.asarray`` slices by column):
  the block ships as floats;
* a :class:`~pygemma_tpu_torch.io.packed.PackedMatrix`: 2-bit codes plus
  the (B,) affine vectors ship (16x fewer bytes than float32) and are
  unpacked and dequantized on the device;
* a :class:`~pygemma_tpu_torch.io.quantized.QuantizedMatrix`: int8 codes
  plus the affine (4x fewer bytes).

On a CUDA device a worker thread fills a ring of pinned host buffers and
copies them on a side stream; the consumer's stream waits on the copy's
event and then dequantizes, so a block reaches the caller as a float tensor
on the consumer's stream.  On the CPU a block is a padded host slice.

Packed blocks can also stay on the device between scans (the device block
cache below), filled either by the scan itself or ahead of it by
:func:`prefill_device_cache`.

With tracing on (utils/profiling.py) the consumer's waits for a block are
``stream.wait`` spans, the worker's fills ``stream.fill`` spans and the
device dequantization ``dequant`` spans.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import threading
from collections import deque
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..parallel.mesh import local_columns
from ..utils import profiling
from .packed import PackedMatrix, dequantize_packed_device
from .quantized import QuantizedMatrix, dequantize_device


def _cache_budget_bytes() -> int:
    """Byte budget of the device block cache: ``PYGEMMA_TPU_GENO_DEV_CACHE_MB``
    (0, the default, turns the cache off; device memory belongs to the scan
    unless the user opts in)."""
    try:
        return int(float(os.environ.get(
            "PYGEMMA_TPU_GENO_DEV_CACHE_MB", "0")) * 2**20)
    except ValueError:
        return 0


class _CacheEntry(NamedTuple):
    tensors: Tuple[torch.Tensor, ...]  # packed codes, mu, sd on the device
    ready: Optional[torch.cuda.Event]  # recorded after the copies (CUDA)
    nbytes: int


class DeviceBlockCache:
    """Packed device blocks keyed by (cache token, start, stop, block,
    device), so repeated scans of one cohort skip the host slice and the
    transfer.  Packed codes are kept, not the 16x larger floats.  Insertion
    stops at the byte budget; nothing is evicted (a scan touches every
    block each pass, so LRU would evict exactly what comes next).

    One lock guards lookup, insert and the byte count, so a prefill thread
    racing the scan can neither insert a key twice nor count its bytes
    twice."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict = {}
        self.nbytes = 0

    def get(self, key) -> Optional[_CacheEntry]:
        with self._lock:
            return self._entries.get(key)

    def admits(self, key, nbytes: int, budget: int) -> Optional[bool]:
        """None when ``key`` is present; else whether ``nbytes`` more fit."""
        with self._lock:
            if key in self._entries:
                return None
            return self.nbytes + nbytes <= budget

    def insert(self, key, entry: _CacheEntry, budget: int) -> bool:
        """Insert unless present or over budget; True when inserted."""
        with self._lock:
            if key in self._entries or self.nbytes + entry.nbytes > budget:
                return False
            self._entries[key] = entry
            self.nbytes += entry.nbytes
            return True

    def entry_bytes(self) -> int:
        """Sum of the entries' bytes (equals :attr:`nbytes`)."""
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.nbytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: the process's device block cache (io/streaming.py's streamer and prefill)
_DEV_BLOCK_CACHE = DeviceBlockCache()


def clear_device_block_cache() -> None:
    _DEV_BLOCK_CACHE.clear()


class _PinnedStager:
    """Host->device copies through a ring of pinned host buffers on a side
    stream.  A slot is refilled only after the copy that last read it is
    done; every copy records a fresh event the consumer waits on."""

    def __init__(self, device: torch.device, specs, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.bufs = [[torch.empty(shape, dtype=dt, pin_memory=True)
                      for shape, dt in specs] for _ in range(slots)]
        self.done: List[Optional[torch.cuda.Event]] = [None] * slots
        self.k = 0

    def put(self, fill) -> Tuple[Tuple[torch.Tensor, ...], torch.cuda.Event]:
        slot = self.k % len(self.bufs)
        self.k += 1
        if self.done[slot] is not None:
            self.done[slot].synchronize()
        bufs = self.bufs[slot]
        fill([b.numpy() for b in bufs])
        with torch.cuda.stream(self.stream):
            out = tuple(b.to(self.device, non_blocking=True) for b in bufs)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        self.done[slot] = ready
        return out, ready


class SnpBlockStreamer:
    """Iterate (start, stop, device_block) with ``depth`` blocks in flight.

    ``X`` is an (n, p) ndarray, a PackedMatrix or a QuantizedMatrix; blocks
    are padded to ``block`` columns with zeros (zero codes for the coded
    kinds, whose padding columns the caller drops with the block's tail).

    With ``shard=(index, count)`` (a rank of a mesh's ``snp`` axis) each
    block yields only that share of its columns, ``block / count`` wide
    (:func:`~pygemma_tpu_torch.parallel.mesh.local_columns`): only those
    columns, or their codes, are read and shipped.  The yielded (start,
    stop) stay the whole block's.
    """

    def __init__(self, X, block: int, dtype=np.float32, device="cuda",
                 depth: Optional[int] = None,
                 shard: Optional[Tuple[int, int]] = None):
        self.X = X
        self.block = block
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        self.p = X.shape[1]
        if shard is not None and block % shard[1]:
            raise ValueError(f"a block of {block} columns does not split "
                             f"into {shard[1]} equal shares")
        self.shard = shard
        width = block if shard is None else block // shard[1]
        # prefetch depth: how many blocks are sliced/shipped ahead of the
        # consumer (env override for measurements)
        self.depth = max(1, int(
            depth if depth is not None
            else os.environ.get("PYGEMMA_TPU_PREFETCH", "2")))
        self._cuda = self.device.type == "cuda"
        self._stager: Optional[_PinnedStager] = None
        if isinstance(X, PackedMatrix):
            self.kind = "packed"
            n_rows = (X.n + 3) // 4
            code_dtype = np.uint8
        elif isinstance(X, QuantizedMatrix):
            self.kind = "int8"
            n_rows = X.shape[0]
            code_dtype = np.int8
        else:
            self.kind = "dense"
            self._specs = [((X.shape[0], width), self.dtype)]
        if self.kind != "dense":
            if self.dtype != np.float32:
                raise ValueError(
                    f"{type(X).__name__} blocks dequantize to float32, not "
                    f"{self.dtype}")
            self._specs = [((n_rows, width), code_dtype),
                           ((width,), np.float32), ((width,), np.float32)]
        # the device block cache holds packed blocks of file-backed matrices
        token = X.cache_token if self.kind == "packed" else None
        self._token = token if _cache_budget_bytes() > 0 else None

    @property
    def block_bytes(self) -> int:
        """Bytes one block moves from the host to the device."""
        return sum(int(np.prod(shape)) * np.dtype(dt).itemsize
                   for shape, dt in self._specs)

    def _fill(self, start: int, stop: int, outs) -> None:
        """Write block [start, stop), or this shard's columns of it,
        zero-padded into host arrays ``outs`` (padded affine columns get
        sd = 1)."""
        if self.shard is not None:
            start, stop = local_columns(start, stop, self.block, self.shard)
        m = stop - start
        if self.kind == "dense":
            outs[0][:, :m] = self.X[:, start:stop]
            outs[0][:, m:] = 0
            return
        outs[0][:, m:] = 0
        outs[1][m:] = 0
        outs[2][m:] = 1
        if m:
            outs[0][:, :m], outs[1][:m], outs[2][:m] = self.X.quant_block(
                start, stop)

    def _stage(self, start: int, stop: int):
        """Block [start, stop) on the device as its raw tensors, plus the
        event its copies recorded (None on the CPU)."""
        with profiling.span("stream.fill", start=start, stop=stop,
                            bytes=self.block_bytes):
            if self._cuda:
                return self._stager.put(
                    lambda outs: self._fill(start, stop, outs))
            outs = [np.empty(shape, dt) for shape, dt in self._specs]
            self._fill(start, stop, outs)
            return tuple(torch.from_numpy(o) for o in outs), None

    def _key(self, start: int, stop: int):
        return (self._token, start, stop, self.block, self.shard,
                str(self.device))

    def _fetch(self, start: int):
        stop = min(start + self.block, self.p)
        if self._token is not None:
            hit = _DEV_BLOCK_CACHE.get(self._key(start, stop))
            if hit is not None:
                return start, stop, hit.tensors, hit.ready
        tensors, ready = self._stage(start, stop)
        if self._token is not None:
            _DEV_BLOCK_CACHE.insert(
                self._key(start, stop),
                _CacheEntry(tensors, ready, self.block_bytes),
                _cache_budget_bytes())
        return start, stop, tensors, ready

    def _decode(self, tensors) -> torch.Tensor:
        if self.kind == "dense":
            return tensors[0].to(self.device)
        with profiling.span("dequant", self.device):
            if self.kind == "packed":
                return dequantize_packed_device(*tensors, n=self.X.n,
                                                coding=self.X.coding)
            return dequantize_device(*tensors,
                                     missing_code=self.X.missing_code)

    def _open(self, n_blocks: int) -> None:
        if self._cuda and self._stager is None:
            self._stager = _PinnedStager(
                self.device, [(shape, torch_dtype(dt))
                              for shape, dt in self._specs],
                min(self.depth + 1, n_blocks))

    def __iter__(self) -> Iterator[Tuple[int, int, torch.Tensor]]:
        starts = list(range(0, self.p, self.block))
        if not starts:
            return
        self._open(len(starts))
        consumer = (torch.cuda.current_stream(self.device) if self._cuda
                    else None)
        # one worker thread keeps host slicing serial; up to ``depth``
        # blocks ride ahead of the consumer
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            pending = deque()
            fetch = profiling.carry(self._fetch)
            for k, s in enumerate(starts):
                pending.append(pool.submit(fetch, s))
                if len(pending) <= self.depth and k + 1 < len(starts):
                    continue
                yield self._ready(pending.popleft(), consumer)
            while pending:
                yield self._ready(pending.popleft(), consumer)

    def _ready(self, future, consumer):
        with profiling.span("stream.wait"):
            start, stop, tensors, ready = future.result()
        if ready is not None:
            consumer.wait_event(ready)
            # the tensors were allocated on another stream: keep the caching
            # allocator from reusing them before the consumer is done
            for t in tensors:
                t.record_stream(consumer)
        return start, stop, self._decode(tensors)


def prefill_device_cache(X, block: int, stop=None, device="cuda") -> int:
    """Ship a PackedMatrix's 2-bit blocks into the device block cache
    without dequantizing them (copies only, no device compute).

    The driver runs it in a background thread (opt-in,
    ``PYGEMMA_TPU_PREFETCH_OVERLAP=1``) so the genotype transfer overlaps
    the kinship eigendecomposition.  It may race the scan: the cache's lock
    makes each key land once, and a key the scan already holds is skipped.
    Stops at the budget, or when ``stop`` (a threading.Event) is set.
    Returns the number of blocks inserted."""
    budget = _cache_budget_bytes()
    if (budget <= 0 or not isinstance(X, PackedMatrix)
            or X.cache_token is None):
        return 0
    streamer = SnpBlockStreamer(X, block, device=device, depth=1)
    n_put = 0
    p = X.shape[1]
    streamer._open(-(-p // block))
    for start in range(0, p, block):
        if stop is not None and stop.is_set():
            break
        stop_col = min(start + block, p)
        key = streamer._key(start, stop_col)
        fits = _DEV_BLOCK_CACHE.admits(key, streamer.block_bytes, budget)
        if fits is None:
            continue
        if not fits:
            break
        tensors, ready = streamer._stage(start, stop_col)
        n_put += _DEV_BLOCK_CACHE.insert(
            key, _CacheEntry(tensors, ready, streamer.block_bytes), budget)
    return n_put
