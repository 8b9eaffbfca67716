"""The program's own spans and counters in a traced run.

After the harness's profiled window, the readers of the span metrics share
two more calls of the cell's program, each made at most once a run:

- (a) ``plain``: tracing on with device markers, and no profiler: honest
  host times, and device times from the spans' CUDA events;
- (b) ``profiled``: tracing on without markers, under ``trace.profiled``:
  each device idle gap goes to the innermost program span of the calling
  thread that holds its middle ("none" where no span does).

Both run ``harness.Program`` on the run's own cohorts (``PackedMatrix.cols``
is a view and the kinship's fingerprint is its content, so nothing is
copied and the eigen cache knows them), on the run's mesh in a multi-card
cell, where every rank runs the same readers and so makes the same calls.
Call (a) takes the window's turn 1 and call (b) turn 2, so each finds the
eigenbasis as the window's calls do: warm with one cohort, cold with two
taking turns.  Against a program
without the span recorder (``utils/profiling.py`` without ``enable`` and
``collect``) every function here returns None.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import NamedTuple, Optional

from . import harness, trace


class Plain(NamedTuple):
    spans: list  # utils/profiling.py Span records of the call
    counters: dict  # change of the program's counters over it
    seconds: float  # the call's wall time, ending in a device sync
    blocks: int  # its ``block`` spans


class Profiled(NamedTuple):
    spans: list
    idle_s: float  # the device's idle time in the profiled call
    idle_in_reml_s: float  # idle time of gaps whose middle is in a ``reml``


_memo: dict = {}


def _once(ctx, key, fn):
    """``fn()`` once per run (``ctx``) and ``key``."""
    if _memo.get("ctx") is not ctx:
        _memo.clear()
        _memo["ctx"] = ctx
    if key not in _memo:
        _memo[key] = fn()
    return _memo[key]


def _recorder():
    """The program's span recorder, or None when it has none."""
    from pygemma_tpu_torch.utils import profiling

    if not all(hasattr(profiling, f) for f in ("enable", "collect")):
        return None
    return profiling


def _counters() -> dict:
    from pygemma_tpu_torch.core import solver

    out = harness.counters()
    out["evaluations"] = getattr(solver.evaluate, "count", None)
    return out


def _call(ctx, turn: int):
    """The cell's program and the cohort of the window's ``turn``."""
    prog = _once(ctx, "program", lambda: harness.Program(
        ctx.cell.config, ctx.cohorts, ctx.device,
        None if ctx.group is None else ctx.group.mesh))
    return lambda: prog.call(turn % len(ctx.cohorts))


def _log(msg: str) -> None:
    print(f"spans: {msg}", file=sys.stderr, flush=True)


def _summary(tag: str, spans: list, counters: dict) -> None:
    """Log what the acceptance of the spans rests on: K1 spans against the
    launch counter, per-block rotations against the blocks, the basis's
    source."""
    blocks = {s.id for s in spans if s.name == "block"}
    rotations = sum(1 for s in spans
                    if s.name == "rotate" and s.parent in blocks)
    k1 = sum(1 for s in spans if s.name == "k1")
    eigen = [s.attrs.get("source") for s in spans if s.name == "eigen"]
    _log(f"{tag}: {len(spans)} spans, {len(blocks)} blocks, {rotations} "
         f"block rotations, {k1} k1 spans for {counters['k1_launches']} "
         f"launches, eigen {eigen}, counters {counters}")


def plain(ctx) -> Optional[Plain]:
    """Call (a); None against a program without the recorder."""
    prof = _recorder()
    if prof is None:
        return None

    def run():
        call = _call(ctx, 1)
        before = _counters()
        harness.sync(ctx.device)
        prof.enable(device_markers=True)
        try:
            t0 = time.perf_counter()
            call()
            harness.sync(ctx.device)
            seconds = time.perf_counter() - t0
            spans = prof.collect()
        finally:
            prof.disable()
        after = _counters()
        counters = {k: (after[k] - before[k]
                        if after[k] is not None else None) for k in after}
        _summary(f"call (a) {seconds!r} s", spans, counters)
        return Plain(spans, counters, seconds,
                     sum(1 for s in spans if s.name == "block"))

    return _once(ctx, "plain", run)


def idle_attribution(tr: trace.Trace, spans: list):
    """(idle seconds, idle seconds by innermost span at each gap's middle,
    idle seconds of gaps whose middle lies in a ``reml`` span), over the
    spans of the thread that made the ``pygemma`` call; None when the
    trace holds no device operation."""
    lo, hi = tr.window
    inside = [iv for iv in tr.device if iv.end > lo and iv.start < hi]
    if not inside:
        return None
    idle = trace.gaps(trace.union(inside, lo, hi), lo, hi)
    mids = [(s + e) // 2 for s, e in idle]
    threads = {s.thread for s in spans if s.name == "pygemma"}
    own = sorted((trace.Interval(s.start_ns, s.end_ns, s.name)
                  for s in spans if s.thread in threads),
                 key=lambda iv: (iv.start, -iv.end))
    reml = [iv for iv in own if iv.name == "reml"]
    by_span, in_reml = defaultdict(float), 0.0
    for (s, e), name, where in zip(idle, trace.innermost(own, mids),
                                   trace.innermost(reml, mids)):
        by_span["none" if name == "python" else name] += (e - s) / 1e9
        in_reml += (e - s) / 1e9 if where == "reml" else 0.0
    return sum(e - s for s, e in idle) / 1e9, dict(by_span), in_reml


def profiled(ctx) -> Optional[Profiled]:
    """Call (b), after call (a); None against a program without the
    recorder."""
    prof = _recorder()
    if prof is None:
        return None
    plain(ctx)  # (a) takes turn 1 first, whichever reader asks first

    def run():
        call = _call(ctx, 2)
        before = _counters()
        prof.enable(device_markers=False)
        try:
            _, tr = trace.profiled(call)
            spans = prof.collect()
        finally:
            prof.disable()
        after = _counters()
        _summary("call (b)", spans, {k: (after[k] - before[k]
                                        if after[k] is not None else None)
                                    for k in after})
        got = idle_attribution(tr, spans)
        if got is None:
            return Profiled(spans, 0.0, 0.0)
        idle_s, by_span, in_reml = got
        window_s = (tr.window[1] - tr.window[0]) / 1e9
        _log(f"call (b): idle {idle_s!r} s of {window_s!r} s, by span "
             f"{trace.top(by_span, len(by_span))}")
        return Profiled(spans, idle_s, in_reml)

    return _once(ctx, "profiled", run)


# --- span arithmetic shared by the readers -------------------------------


def nearest(span, name: str, by_id: dict):
    """The nearest enclosing span of ``span`` named ``name``, or None."""
    parent = by_id.get(span.parent)
    while parent is not None and parent.name != name:
        parent = by_id.get(parent.parent)
    return parent


def under(spans: list, name: str, ancestor: str) -> list:
    """The spans named ``name`` that lie inside a span named
    ``ancestor``."""
    by_id = {s.id: s for s in spans}
    return [s for s in spans
            if s.name == name and nearest(s, ancestor, by_id) is not None]


def timed(spans: list) -> list:
    """The spans that carry device times."""
    return [s for s in spans if s.device_ns is not None]
