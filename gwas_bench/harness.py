"""One run of one cell: set-up, the measured window, the check, the line.

The system under test is ``pygemma_tpu_torch.pygemma`` as a user calls it:
whole calls from (Y, X, W, K) to the table, each ended by the table
reaching the host.  Set-up draws the cohorts on the device, builds what
the program builds at first use (K1 with nvcc, its caches), and makes one
call on the last cohort of the cell's traffic (the cohorts share their
shapes), which leaves that cohort's eigenbasis in the program's cache.
The window then runs whole
calls until ``seconds`` have passed, the last call included, taking turns
over the cohorts from the first: with one cohort every call finds its
basis warm, with two the program's one-entry cache misses on every call.
A traced run (``trace``) profiles exactly one such call as its window and
reads the cell's per-layer metrics from it.

A cell on more than one card (``chips`` > 1) runs this in each of its rank
processes (``launch.py``, ``ranks.py``): the calls take the traffic's mesh,
every rank makes every call in the same order, rank 0 decides before each
window call whether another is made, and rank 0 alone reports and judges,
with the fullest card's peak and every other rank's tables held to its own.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from . import cohorts as gen
from . import judge, spec, trace
from .launch import forbidden_modules, process_start


class Program:
    """``pygemma`` on the cell's cohorts, as the configuration states."""

    def __init__(self, cfg: dict, cohorts, device, mesh=None):
        import pygemma_tpu_torch as pt
        from pygemma_tpu_torch.io.packed import PackedMatrix

        self.pt = pt
        self.device = device
        self.mesh = mesh
        self.gcfg = pt.GwasConfig(snp_block=cfg["snp_block"])
        kin = cfg["kinship"]
        self.inputs = []
        for co in cohorts:
            X = (PackedMatrix(co.packed.T, co.n, co.mu, co.sd)
                 if co.packed is not None else co.X)
            if kin["type"] == "lowrank_grm":
                G = (X.cols(0, kin["snps"]) if co.packed is not None
                     else X[:, :kin["snps"]])
                K = pt.LowRankKinship(G, eps=kin["ridge"])
            else:
                K = co.K
            Y = co.Y[:, 0] if co.Y.shape[1] == 1 else co.Y
            self.inputs.append((Y, X, co.W, K))

    def call(self, i: int) -> dict:
        """One study of cohort ``i``: its table as (k, p) columns."""
        Y, X, W, K = self.inputs[i]
        df = self.pt.pygemma(Y, X, W, K, config=self.gcfg,
                             device=self.device, mesh=self.mesh)
        k = 1 if Y.ndim == 1 else Y.shape[1]
        out = {}
        for col in judge.COLUMNS:
            a = df[col].to_numpy(np.float64)
            out[col] = a.reshape(k, -1) if a.size % k == 0 else a[None]
        return out


def counters() -> dict:
    from pygemma_tpu_torch import api
    from pygemma_tpu_torch.core import solver
    from pygemma_tpu_torch.ops import gram_kernel

    return {"host_syncs": solver.host_value.count,
            "k1_launches": gram_kernel.fused_grams.launches,
            "rotations": api._rotate_top.count}


class Window(NamedTuple):
    seconds: float
    calls: list  # judge.Call
    tests: int
    blocks: int
    peak_bytes: int


class Context(NamedTuple):
    """What a per-layer metric's reader gets (``metrics/<name>.py``)."""

    cell: spec.Cell
    cohorts: list
    device: torch.device
    reduced: trace.Reduced
    blocks: int  # SNP blocks streamed in the traced window
    counters: dict  # change of the program's counters over it
    peaks: dict  # the card's published peaks (None if not in the table)
    group: object = None  # ranks.Group of a multi-card cell, else None


E2E = {
    "snp_tests_per_s": lambda w, setup: w.tests / w.seconds,
    "study_s": lambda w, setup: w.seconds / len(w.calls),
    "peak_device_gib": lambda w, setup: w.peak_bytes / 2 ** 30,
    "setup_s": lambda w, setup: setup,
}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _another(calls: list, t0: float, seconds: float, group) -> bool:
    """Whether the window makes another call: always a first, then until
    ``seconds`` have passed; in a multi-card cell, rank 0's answer."""
    go = not calls or time.perf_counter() - t0 < seconds
    return go if group is None else group.decide(go)


def _ranks_agree(group, calls: list, setup_peak: int, peak: int):
    """Every rank's peaks and table digests, gathered: (the fullest card's
    set-up-and-window peak, the fullest card's window peak, the other
    ranks' calls whose table differs from rank 0's, a missing or extra call
    counting as one, this rank's digests)."""
    from . import ranks

    mine = [ranks.table_digest(c.table) for c in calls]
    every = group.gather((max(setup_peak, peak), peak, mine))
    ref = every[0][2]
    differ = sum(sum(a != b for a, b in zip(ref, d[2]))
                 + abs(len(ref) - len(d[2])) for d in every[1:])
    return max(e[0] for e in every), max(e[1] for e in every), differ, mine


def run(name: str, seed: int, seconds: float, traced: bool, device="cuda",
        cell: spec.Cell = None, started: float = None, log=print) -> dict:
    """One run of cell ``name``; returns the result line's object (None on
    a rank other than 0 of a multi-card cell).  Tests pass a shrunken
    ``cell`` and ``device="cpu"``."""
    started = process_start() if started is None else started
    cell = cell or spec.load_cell(name)
    dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    k, p = traffic["phenotypes"], cfg["p"]
    n_blocks = -(-p // cfg["snp_block"])

    # --- set-up -----------------------------------------------------------
    log(f"set-up: started {time.time() - started!r} s ago")
    group = None
    if cell.chips > 1:
        from . import ranks

        group = ranks.Group(traffic["mesh"], cell.chips, dev)
        dev = group.device
        log(f"set-up: rank {group.rank} of {group.size} on {dev} at "
            f"{time.time() - started!r} s")
    torch.zeros(1, device=dev)  # the device's context
    log(f"set-up: device ready at {time.time() - started!r} s")
    cohorts = gen.make_cohorts(cfg, traffic, seed, dev)
    sync(dev)
    log(f"set-up: cohorts drawn at {time.time() - started!r} s")
    if group is not None:
        group.same_inputs(cohorts)
        group.build(cfg)
        log(f"set-up: inputs agree, libraries built at "
            f"{time.time() - started!r} s")
    prog = Program(cfg, cohorts, dev, None if group is None else group.mesh)
    prog.call(len(cohorts) - 1)
    sync(dev)
    if group is not None:
        group.barrier()
    setup_s = time.time() - started
    setup_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else 0)
    log(f"setup_s {setup_s!r} setup_peak_bytes {setup_peak}")

    # --- the window -------------------------------------------------------
    def turn(j):  # the window's j-th call takes this cohort
        return j % len(cohorts)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = counters()
    calls = []
    if traced:
        table, tr = trace.profiled(lambda: prog.call(turn(0)))
        calls.append(judge.Call(turn(0), table))
        red = trace.reduce(tr)
        window_s = red.window_s
    else:
        t0 = time.perf_counter()
        ends = []
        while _another(calls, t0, seconds, group):
            i = turn(len(calls))
            calls.append(judge.Call(i, prog.call(i)))
            ends.append(time.perf_counter() - t0)
        sync(dev)
        window_s = time.perf_counter() - t0
        log(f"window {window_s!r} s, calls ending at {ends}")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    after = counters()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}")
    memory_peak = max(setup_peak, peak)
    if group is not None:
        memory_peak, peak, differ, digests = _ranks_agree(
            group, calls, setup_peak, peak)
        log(f"window: {len(calls)} calls, peak {peak} bytes on the fullest "
            f"card, table digests {digests}")
    w = Window(window_s, calls, len(calls) * k * p, len(calls) * n_blocks,
               peak)

    result = {"correct": False, "attempted": w.tests,
              "failed": judge.failed(calls, k, p)}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": cell.chips, "memory_peak_bytes": memory_peak}
    if traced:
        ctx = Context(cell, cohorts, dev, red, w.blocks,
                      {key: after[key] - before[key] for key in after},
                      spec.peaks(dev_info["kind"]), group)
        metrics = {}
        for m in cell.per_layer:  # every rank reads them, in this order
            value = spec.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = red.busy_s
        dev_info["window_s"] = red.window_s
        result["breakdown"] = {
            "device_ops": trace.top(red.ops_by_name),
            "idle_gaps": trace.top(red.idle_by_host_op)}
        from pygemma_tpu_torch.ops import gram_kernel

        kept = red.launches_by_name
        k1 = sum(v for name, v in kept.items()
                 if gram_kernel.KERNEL_NAMES[0] in name)
        log(f"trace: {red.device_ops} device ops, {w.blocks} blocks, "
            f"counters {ctx.counters}, K1 launches in the trace {k1}")
    else:
        metrics = {m["name"]: {"value": E2E[m["name"]](w, setup_s),
                               "unit": m["unit"]} for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = dev_info

    # --- the check, after the window and the memory reading ---------------
    del prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if group is not None and group.rank != 0:
        group.close()  # waits for rank 0's check
        return None
    t0 = time.perf_counter()
    rng = np.random.default_rng(gen.derive(seed, "judge"))
    rows = judge.sample(calls, k, p, cfg["snp_block"], rng)
    per_row = judge.compare(calls, cohorts, cfg, rows, dev)
    numbers = judge.summary(per_row, result["failed"])
    if group is not None:
        numbers["rank_mismatch"] = float(differ)
    log(f"check of {len(rows)} answers: {time.perf_counter() - t0!r} s")
    result["correct"] = judge.verdict(numbers, cell.limits)
    result["checks"] = {
        name: {"value": v if math.isfinite(v) else None,
               "limit": cell.limits[name]["limit"]}
        for name, v in numbers.items()}
    if group is not None:
        group.close()
    return result
