"""The traced window: torch.profiler's events kept in memory, reduced to
busy time, idle gaps and device operations by name.

Busy and idle come from one profiled window: the device's busy time is
the union of its kernel, copy and set intervals inside the window, and the
window is the host's wall time of the same profiled call (both on the
profiler's clock, nanoseconds since the epoch).  An idle gap is named by
the innermost host operator running on the calling thread at its middle
("python" where none is).  The raw events are read straight from the
profiler's results, without building its event tree.
"""

from __future__ import annotations

import time
from collections import Counter, defaultdict
from typing import List, NamedTuple, Tuple


class Interval(NamedTuple):
    start: int
    end: int
    name: str


class Trace(NamedTuple):
    window: Tuple[int, int]  # host wall clock of the window, ns
    device: List[Interval]  # kernels, copies and sets, sorted by start
    host: List[Interval]  # host operators of the calling thread


def union(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    """Merged (start, end) spans of ``intervals`` clipped to [lo, hi]."""
    spans = []
    for s, e, *_ in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if spans and s <= spans[-1][1]:
            spans[-1] = (spans[-1][0], max(spans[-1][1], e))
        else:
            spans.append((s, e))
    return spans


def gaps(spans, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle spans of [lo, hi] between merged busy ``spans``."""
    out, t = [], lo
    for s, e in spans:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(host: List[Interval], points: List[int]) -> List[str]:
    """For each of the sorted ``points``, the name of the innermost host
    interval containing it ("python" where none does).  The intervals of
    one thread nest, so a stack swept along the points finds it."""
    names, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i].start <= t:
            while stack and stack[-1].end < host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        names.append(stack[-1].name if stack else "python")
    return names


class Reduced(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: int
    ops_by_name: dict  # name -> device seconds
    launches_by_name: Counter
    idle_by_host_op: dict  # name -> idle seconds


def reduce(tr: Trace) -> Reduced:
    lo, hi = tr.window
    inside = [iv for iv in tr.device if iv.end > lo and iv.start < hi]
    spans = union(inside, lo, hi)
    busy = sum(e - s for s, e in spans)
    by_name, count = defaultdict(float), Counter()
    for iv in inside:
        by_name[iv.name] += (iv.end - iv.start) / 1e9
        count[iv.name] += 1
    idle = gaps(spans, lo, hi)
    mids = [(s + e) // 2 for s, e in idle]
    idle_by = defaultdict(float)
    for (s, e), name in zip(idle, innermost(tr.host, mids)):
        idle_by[name] += (e - s) / 1e9
    return Reduced((hi - lo) / 1e9, busy / 1e9, len(inside), dict(by_name),
                   count, dict(idle_by))


def top(d: dict, k: int = 10) -> list:
    return [[name, v]
            for name, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def profiled(fn):
    """Run ``fn()`` (which ends in a device sync) under torch.profiler and
    return (its result, the Trace of that window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
    device, by_thread = [], defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        iv = Interval(s, s + ev.duration_ns(), ev.name())
        if ev.device_type() == DeviceType.CUDA:
            device.append(iv)
        elif not iv.name.startswith(("cuda", "cu")):  # runtime calls
            by_thread[ev.start_thread_id()].append(iv)
    device.sort()
    # the calling thread is the one with the most host operators
    host = max(by_thread.values(), key=len) if by_thread else []
    host.sort(key=lambda iv: (iv.start, -iv.end))
    return out, Trace((t0, t1), device, host)


def kernel_ms(fn, names, reps: int = 30):
    """Mean device ms per call of ``fn`` for the kernels whose names
    contain one of ``names``, summed over them, under torch.profiler over
    ``reps`` calls after a warm-up.  None when a name never shows."""
    import torch

    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            fn()

    _, tr = profiled(calls)
    total = 0.0
    for name in names:
        us = [(iv.end - iv.start) / 1e3 for iv in tr.device if name in iv.name]
        if not us:
            return None
        total += sum(us) / len(us) / 1e3
    return total
