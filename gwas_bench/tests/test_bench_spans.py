"""The span metrics on the CPU: ``spans.py``'s two calls at a test's size,
the readers (the device-marker metrics read nothing without a card, the
host ones read finite values), the attribution of idle gaps to spans, the
readers against a program without the recorder, and the frozen rotation
work."""

import json
import math

import pytest
import torch

from conftest import ROOT, SEED
from gwas_bench import cohorts as gen
from gwas_bench import harness, spans, spec, trace

HOST = {"stream_wait_ms.scan", "reml_ms.scan", "lambda_evals.scan",
        "lambda_evals.study"}
DEVICE = {"rotate_roofline.scan", "k1_calls_roofline.scan",
          "dequant_ms.scan", "eigen_s.study", "idle_in_reml.scan",
          "idle_in_reml.study"}


def _window_ctx(cell):
    """A run's Context after set-up and a one-call window, as
    ``harness.run`` leaves it for the readers."""
    dev = torch.device("cpu")
    cohorts = gen.make_cohorts(cell.config, cell.traffic, SEED, dev)
    prog = harness.Program(cell.config, cohorts, dev)
    prog.call(len(cohorts) - 1)  # set-up's warm-up
    prog.call(0)  # the window's turn 0
    blocks = -(-cell.config["p"] // cell.config["snp_block"])
    return harness.Context(cell, cohorts, dev, None, blocks, {}, None)


def test_new_metrics_are_all_listed():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer"]}
    assert HOST | DEVICE <= names


@pytest.mark.parametrize("name", ["ukb_synth_50k.scan",
                                  "wtccc_dense_10k.study"])
def test_readers_on_the_cpu(small_cell, name):
    cell = small_cell(name)
    ctx = _window_ctx(cell)
    mine = {m["name"] for m in cell.per_layer} & (HOST | DEVICE)
    assert mine
    for metric in sorted(mine):
        value = spec.reader(metric).read(ctx)
        if metric in DEVICE:
            assert value is None, metric
        else:
            assert isinstance(value, float) and math.isfinite(value), metric
            assert value >= 0


@pytest.mark.parametrize("name,source", [("ukb_synth_50k.scan", "cache"),
                                         ("wtccc_dense_10k.study",
                                          "computed")])
def test_the_two_calls(small_cell, name, source):
    cell = small_cell(name)
    ctx = _window_ctx(cell)
    b = spans.profiled(ctx)  # asks for (a) first
    a = spans.plain(ctx)
    assert spans.plain(ctx) is a and spans.profiled(ctx) is b
    blocks = -(-cell.config["p"] // cell.config["snp_block"])
    for got in (a, b):
        eig = [s.attrs["source"] for s in got.spans if s.name == "eigen"]
        assert eig == [source]
        assert sum(1 for s in got.spans if s.name == "block") == blocks
    assert a.blocks == blocks and a.seconds > 0
    lams = [s for s in a.spans if s.name == "lambda"]
    assert sum(s.attrs["evals"] for s in lams) == a.counters["evaluations"]
    rot = spans.under(a.spans, "rotate", "block")
    assert len(rot) == blocks
    assert b.idle_s == 0.0  # no device operation on the CPU


def test_readers_without_the_recorder(small_cell, monkeypatch):
    """Against a program that has no span recorder, every new reader
    reads nothing and raises nothing."""
    monkeypatch.setattr(spans, "_recorder", lambda: None)
    cell = small_cell("ukb_synth_50k.scan")
    ctx = _window_ctx(cell)._replace(peaks={"hbm_bytes_per_s": 1.0,
                                            "fp32_grade_flops_per_s": 1.0})
    for metric in sorted(HOST | DEVICE):
        assert spec.reader(metric).read(ctx) is None, metric


def _span(name, sid, parent, start, end, thread=1):
    from pygemma_tpu_torch.utils.profiling import Span

    return Span(name, sid, parent, 1, thread, start, end, None, None, {})


def test_idle_gaps_go_to_the_innermost_span():
    tr = trace.Trace((0, 100), [trace.Interval(10, 20, "k"),
                                trace.Interval(50, 60, "k")], [])
    recs = [_span("pygemma", 1, None, 0, 100), _span("reml", 2, 1, 30, 70),
            _span("sync", 3, 2, 40, 45),
            _span("stream.fill", 4, 1, 0, 100, thread=2)]
    idle_s, by_span, in_reml = spans.idle_attribution(tr, recs)
    # gaps (0, 10), (20, 50), (60, 100): middles 5, 35, 80
    assert idle_s == pytest.approx(80e-9)
    assert by_span == pytest.approx({"pygemma": 50e-9, "reml": 30e-9})
    assert in_reml == pytest.approx(30e-9)
    assert spans.idle_attribution(trace.Trace((0, 100), [], []), recs) \
        is None


@pytest.mark.parametrize("r,n,B,flops,nbytes", [
    (16_384, 50_000, 4_096, 6_710_886_400_000.0, 4_364_435_456.0),
    (10_000, 10_000, 2_048, 409_600_000_000.0, 563_840_000.0),
])
def test_frozen_rotation_work(r, n, B, flops, nbytes):
    assert spec.work("rotate").flops_and_bytes(r, n, B) == (flops, nbytes)
