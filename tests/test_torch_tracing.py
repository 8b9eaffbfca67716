"""The port's span recorder (utils/profiling.py) on the CPU: off records
nothing, on changes no table, the spans nest as the program's layers do,
their counts match the program's counters, and none enters a
torch.profiler trace."""

import threading

import numpy as np
import pandas as pd
import pytest
import torch

import oracle
import pygemma_tpu_torch as pt
from pygemma_tpu_torch import api as tapi
from pygemma_tpu_torch.core import solver
from pygemma_tpu_torch.io.packed import PackedMatrix
from pygemma_tpu_torch.ops import gram_kernel
from pygemma_tpu_torch.utils import profiling

torch.set_num_threads(2)

CPU = "cpu"
BLOCK = 64
NAMES = ("pygemma", "eigen", "null_fit", "scan", "block", "table", "rotate",
         "reml", "lambda", "sync", "k1", "stream.wait", "stream.fill",
         "dequant", "lowrank.stream_gram", "lowrank.gram_eigh",
         "lowrank.top_basis")


def _dense(k=1):
    y, G, W, K = oracle.simulate(n=120, p=200, c=3, seed=7)
    if k > 1:
        rng = np.random.default_rng(8)
        y = np.column_stack([y] + [y + rng.normal(size=y.shape)
                                   for _ in range(k - 1)])
    return y, G.astype(np.float32), W, K


def _packed():
    rng = np.random.default_rng(9)
    n, p, pk = 150, 256, 40
    codes = rng.binomial(2, 0.3, size=(n, p)).astype(np.uint8)
    X = PackedMatrix.from_codes(codes)
    W = np.column_stack([np.ones(n), rng.normal(size=(n, 2))])
    y = rng.normal(size=n)
    return y, X, W, pt.LowRankKinship(X.cols(0, pk), eps=1e-3)


CASES = {"dense": lambda: _dense(), "packed_lowrank": _packed,
         "batched_k4": lambda: _dense(k=4)}


def _scan(case, **kw):
    y, X, W, K = case
    return pt.pygemma(y, X, W, K, config=pt.GwasConfig(snp_block=BLOCK),
                      device=CPU, **kw)


def _traced(case, **kw):
    profiling.enable()
    try:
        df = _scan(case, **kw)
        return df, profiling.collect()
    finally:
        profiling.disable()


@pytest.fixture(autouse=True)
def _fresh():
    tapi._EIGEN_DEV_CACHE.clear()
    profiling.disable()
    profiling.collect()
    yield
    profiling.disable()
    profiling.collect()


def test_off_records_nothing():
    with profiling.span("rotate", CPU, r=1) as sp:
        sp.set(n=2)
    _scan(CASES["dense"]())
    assert profiling.collect() == []


@pytest.mark.parametrize("name", list(CASES))
def test_table_is_bit_identical_on_and_off(name):
    case = CASES[name]()
    off = _scan(case)
    on, spans = _traced(case)
    assert spans
    pd.testing.assert_frame_equal(on, off, check_exact=True)


@pytest.mark.parametrize("name", ["dense", "packed_lowrank"])
def test_span_tree(name):
    _, spans = _traced(CASES[name]())
    by_id = {s.id: s for s in spans}
    (call,) = [s for s in spans if s.name == "pygemma"]
    assert call.call == call.id and call.parent is None
    assert all(s.call == call.id for s in spans)
    assert call.attrs["path"] == ("implicit" if name == "packed_lowrank"
                                  else "rotated")
    blocks = [s for s in spans if s.name == "block"]
    assert len(blocks) == -(-call.attrs["p"] // BLOCK)
    for b in blocks:
        scan = by_id[b.parent]
        assert scan.name == "scan" and scan.parent == call.id
        assert scan.start_ns <= b.start_ns <= b.end_ns <= scan.end_ns
        assert call.start_ns <= scan.start_ns <= scan.end_ns <= call.end_ns
        rotations = [s for s in spans
                     if s.name == "rotate" and s.parent == b.id]
        assert len(rotations) == 1
    scans = {s.id for s in spans if s.name == "scan"}
    fills = [s for s in spans if s.name == "stream.fill"]
    assert len([f for f in fills if f.parent in scans]) == len(blocks)
    for f in fills:  # the scan's, and the low-rank Gram's stream
        assert f.thread != call.thread and f.attrs["bytes"] > 0
        assert by_id[f.parent].name in ("scan", "lowrank.stream_gram")
    dequant = [s for s in spans if s.name == "dequant" and s.parent in scans]
    assert len(dequant) == (len(blocks) if name == "packed_lowrank" else 0)
    eigen = [s for s in spans if s.name == "eigen"]
    assert [s.attrs["source"] for s in eigen] == ["computed"]
    assert all(s.device_start_ns is None for s in spans)  # no card here


def test_counts_match_the_program_counters():
    case = CASES["packed_lowrank"]()
    before = (gram_kernel.fused_grams.launches, tapi._rotate_top.count)
    _, spans = _traced(case)
    blocks = {s.id for s in spans if s.name == "block"}
    k1 = [s for s in spans if s.name == "k1"]
    assert len(k1) == gram_kernel.fused_grams.launches - before[0]
    per_block = [s for s in spans if s.name == "rotate" and s.parent in blocks]
    assert len(per_block) == tapi._rotate_top.count - before[1] == len(blocks)
    r = per_block[0].attrs
    assert (r["r"], r["n"], r["B"]) == (40, 150, BLOCK)


def test_evaluations_match_the_lambda_spans():
    case = CASES["dense"]()
    evals, syncs = solver.evaluate.count, solver.host_value.count
    _, spans = _traced(case, tests=("wald", "lrt"))
    lams = [s for s in spans if s.name == "lambda"]
    assert len(lams) >= 4  # REML and ML per block, and the null fits
    assert sum(s.attrs["evals"] for s in lams) == \
        solver.evaluate.count - evals
    assert len([s for s in spans if s.name == "sync"]) == \
        solver.host_value.count - syncs
    by_id = {s.id: s for s in spans}
    assert {by_id[s.parent].name for s in lams} == {"reml", "null_fit"}
    assert all(s.attrs["batches"] >= 0 and s.attrs["newton"] >= 0
               for s in lams)
    # the REML kernel runs on the card only
    assert all(s.attrs["kernel_evals"] == 0 for s in lams)


def test_a_span_closes_when_its_body_raises():
    profiling.enable()
    with pytest.raises(ValueError):
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise ValueError("boom")
    with profiling.span("after"):
        pass
    spans = {s.name: s for s in profiling.collect()}
    assert set(spans) == {"outer", "inner", "after"}
    assert spans["inner"].parent == spans["outer"].id
    assert spans["outer"].end_ns >= spans["inner"].end_ns
    assert spans["after"].parent is None


def test_carry_takes_the_span_to_another_thread():
    profiling.enable()
    def fill():
        with profiling.span("stream.fill"):
            pass

    with profiling.span("pygemma") as outer:
        t = threading.Thread(target=profiling.carry(fill))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    spans = {s.name: s for s in profiling.collect()}
    fill = spans["stream.fill"]
    assert fill.parent == outer.id == fill.call
    assert fill.thread != spans["pygemma"].thread


@pytest.mark.parametrize("on", [False, True])
def test_no_span_enters_a_profiler_trace(on):
    from torch.profiler import ProfilerActivity, profile

    case = CASES["packed_lowrank"]()
    if on:
        profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _scan(case)
    profiling.disable()
    seen = {e.name for e in prof.events()}
    assert any(name.startswith("aten::") for name in seen)
    assert not seen & set(NAMES)
    assert bool(profiling.collect()) == on
