"""Spans of the program's own layers, recorded in memory.

Tracing is off by default.  Then :func:`span` returns a shared context that
does nothing, so a span costs one module-flag check: no CUDA event, no
device sync, no profiler annotation, no device allocation.  Turned on, it
changes the order and content of no computation.

    from pygemma_tpu_torch.utils import profiling
    profiling.enable()           # device_markers=True: CUDA timing events
    df = pygemma(y, X, W, K)
    spans = profiling.collect()  # the finished spans, oldest first
    profiling.disable()

Each :class:`Span` holds its name, its own id and its parent's (a stack per
thread), the id of the enclosing ``pygemma`` call, the thread, its host
start and end in ``time.time_ns()``, and, for a span given a CUDA device
while markers are on, the device time of a timing event recorded on the
current stream at enter and at exit.  :func:`collect` synchronizes once and
places those events on the same epoch clock through one anchor event,
recorded with a synchronize by :func:`enable`, so a span's host and device
intervals share one clock with torch.profiler's trace.

No span ever enters a torch.profiler trace: the recorder makes no
``record_function`` range, which the profiler would report as a device
event of its own.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

_on = False
_markers = False
_lock = threading.Lock()
_done: list = []  # closed live spans, oldest first
_ids = itertools.count(1)
_local = threading.local()
_pool: dict = {}  # CUDA device index -> timing events free for reuse
_anchors: dict = {}  # CUDA device index -> (anchor event, its host ns)


class Span(NamedTuple):
    """One finished span; times in nanoseconds since the epoch."""

    name: str
    id: int
    parent: Optional[int]
    call: Optional[int]  # id of the enclosing ``pygemma`` span
    thread: int  # native thread id
    start_ns: int
    end_ns: int
    device_start_ns: Optional[int]  # None without device markers
    device_end_ns: Optional[int]
    attrs: dict

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def device_ns(self) -> Optional[int]:
        if self.device_start_ns is None:
            return None
        return self.device_end_ns - self.device_start_ns


class _Null:
    """The span of tracing that is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _Null()


def _here():
    """This thread's span stack and native id (asked of the system once a
    thread: ``get_native_id`` is a system call)."""
    try:
        return _local.stack, _local.thread
    except AttributeError:
        _local.stack, _local.thread = [], threading.get_native_id()
        return _local.stack, _local.thread


def _event(index: int) -> torch.cuda.Event:
    """A timing event of device ``index`` (an event keeps the device it
    was first recorded on)."""
    try:
        return _pool[index].pop()
    except (KeyError, IndexError):
        return torch.cuda.Event(enable_timing=True)


def _cuda_index(device) -> Optional[int]:
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _anchor(index: int) -> None:
    """Pin device ``index``'s event clock to the host's.  On an idle device
    an event runs after its record call begins and before the wait for it
    returns.  Each of 50 such brackets (~10 ms in all), moved to the first
    event's time by the events' elapsed times, bounds that event's host
    time; their overlap is narrower than any one of them, and its middle is
    the anchor.  (Each event is recorded once before, since its first
    record creates it.)"""
    stream = torch.cuda.current_stream(index)
    tries = []
    for _ in range(50):
        ev = _event(index)
        ev.record(stream)
        torch.cuda.synchronize(index)
        h0 = time.time_ns()
        ev.record(stream)
        ev.synchronize()
        tries.append((ev, h0, time.time_ns()))
    first = tries[0][0]
    shift = [round(first.elapsed_time(ev) * 1e6) for ev, _, _ in tries]
    lo = max(h0 - d for (_, h0, _), d in zip(tries, shift))
    hi = min(h1 - d for (_, _, h1), d in zip(tries, shift))
    _anchors[index] = (first, (lo + hi) // 2)
    _pool.setdefault(index, []).extend(ev for ev, _, _ in tries[1:])


class _Live:
    """An open span: ``set`` adds attributes until it closes."""

    __slots__ = ("name", "index", "attrs", "id", "parent", "call", "thread",
                 "start", "end", "stream", "ev0", "ev1")

    def __init__(self, name, index, attrs):
        self.name, self.index, self.attrs = name, index, attrs
        self.ev0 = self.ev1 = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack, self.thread = _here()
        self.parent, self.call = stack[-1] if stack else (None, None)
        self.id = next(_ids)
        if self.name == "pygemma":
            self.call = self.id
        stack.append((self.id, self.call))
        if self.index is not None:
            if self.index not in _anchors:
                _anchor(self.index)
            self.stream = torch.cuda.current_stream(self.index)
            self.ev0 = _event(self.index)
            self.ev0.record(self.stream)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        if self.ev0 is not None:
            self.ev1 = _event(self.index)
            self.ev1.record(self.stream)
        _here()[0].pop()
        with _lock:
            _done.append(self)
        return False


def span(name: str, device=None, **attrs):
    """A context that records one span named ``name`` while tracing is on
    (none for a ``name`` of None); it yields a handle whose
    ``set(**attrs)`` adds attributes.  With a CUDA ``device`` and markers
    on, the span also takes the device's time."""
    if not _on or name is None:
        return _NULL
    return _Live(name, _cuda_index(device) if _markers else None, attrs)


def carry(fn):
    """``fn`` to run on another thread as a child of this thread's open
    span, in the same ``pygemma`` call; ``fn`` itself when tracing is off."""
    if not _on:
        return fn
    stack = _here()[0]
    top = stack[-1] if stack else (None, None)

    def run(*args, **kwargs):
        inner = _here()[0]
        inner.append(top)
        try:
            return fn(*args, **kwargs)
        finally:
            inner.pop()

    return run


def enable(device_markers: bool = True) -> None:
    """Turn tracing on, dropping spans not yet collected.  With
    ``device_markers`` and a CUDA device, spans given a device take its
    time, and the current device's clock is anchored now (a synchronize)."""
    global _on, _markers
    with _lock:
        _done.clear()
    _anchors.clear()
    _markers = bool(device_markers) and torch.cuda.is_available()
    if _markers:
        _anchor(torch.cuda.current_device())
    _on = True


def disable() -> None:
    """Turn tracing off; spans not yet collected stay until :func:`collect`
    or the next :func:`enable`."""
    global _on
    _on = False


def collect() -> List[Span]:
    """The spans closed since the last collect, oldest first, and clear
    them.  Synchronizes the devices whose events they hold, once."""
    with _lock:
        live = list(_done)
        _done.clear()
    for index in {s.index for s in live if s.ev0 is not None}:
        torch.cuda.synchronize(index)
    out = []
    for s in live:
        d0 = d1 = None
        if s.ev0 is not None:
            anchor, host_ns = _anchors[s.index]
            d0 = host_ns + round(anchor.elapsed_time(s.ev0) * 1e6)
            d1 = host_ns + round(anchor.elapsed_time(s.ev1) * 1e6)
            _pool.setdefault(s.index, []).extend((s.ev0, s.ev1))
        out.append(Span(s.name, s.id, s.parent, s.call, s.thread, s.start,
                        s.end, d0, d1, s.attrs))
    out.sort(key=lambda s: s.start_ns)
    return out
