"""The cold top basis of ``ukb_synth_50k.study``: the frozen work of its two
products, the readers ``gram_eigh_s`` and ``top_basis_roofline`` (nothing
to read without device markers or for a dense kinship; their arithmetic on
spans with device times), the cell's span readers and whole runs on the
CPU at a test's size, and the faults the cell can have refused."""

import math

import pytest

from conftest import SEED
from gwas_bench import faults, harness, spans, spec
from test_bench_spans import _window_ctx

CELL = "ukb_synth_50k.study"
NEW = ("gram_eigh_s.study", "top_basis_roofline.study")
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_grade_flops_per_s": 1.65e14}


def test_frozen_lowrank_work():
    n, pk = 50_000, 16_384
    work = spec.work("lowrank")
    assert work.gram(n, pk) == (13_422_592_000_000.0, 741_703_680.0)
    assert work.top_basis(n, pk) == (26_843_545_600_000.0, 4_350_541_824.0)
    # the formula: the Gram's p_k (p_k + 1) / 2 entries, a multiply-add per
    # sample each; G V 2 n p_k^2; codes, Gram, eigenvectors, U_top once
    tri = pk * (pk + 1) // 2
    assert work.gram(n, pk) == (2.0 * n * tri, n * pk / 4 + 4 * tri)
    assert work.top_basis(n, pk) == (2.0 * n * pk ** 2,
                                     4 * pk ** 2 + 4 * n * pk)


@pytest.mark.parametrize("name", [CELL, "wtccc_dense_10k.study"])
def test_new_readers_read_nothing_on_the_cpu(small_cell, name):
    """No device markers on the CPU; no top basis for a dense kinship."""
    ctx = _window_ctx(small_cell(name))._replace(peaks=PEAKS)
    for metric in NEW:
        assert spec.reader(metric).read(ctx) is None, metric


def _span(name, sid, device_s):
    from pygemma_tpu_torch.utils.profiling import Span

    return Span(name, sid, None, 1, 1, 0, 1, 0, int(device_s * 1e9), {})


@pytest.mark.parametrize("name", [CELL, "wtccc_dense_10k.study"])
def test_new_readers_on_timed_spans(small_cell, monkeypatch, name):
    """Against call (a) spans that carry device times, the readers give the
    sum of the eigh's times and the products' bound over their time, at the
    configuration's own n and p_k; a dense kinship reads no share."""
    cell = spec.load_cell(name)
    ctx = _window_ctx(small_cell(name))._replace(cell=cell, peaks=PEAKS)
    recs = [_span("lowrank.stream_gram", 1, 0.5),
            _span("lowrank.gram_eigh", 2, 1.25),
            _span("lowrank.top_basis", 3, 0.75),
            _span("eigen", 4, 3.0)]
    monkeypatch.setattr(spans, "plain",
                        lambda c: spans.Plain(recs, {}, 3.0, 0))
    eigh = spec.reader("gram_eigh_s.study").read(ctx)
    share = spec.reader("top_basis_roofline.study").read(ctx)
    assert eigh == pytest.approx(1.25)
    if cell.config["kinship"]["type"] != "lowrank_grm":
        assert share is None
        return
    n, pk = cell.config["n"], cell.config["kinship"]["snps"]
    work = spec.work("lowrank")
    bound = sum(max(b / PEAKS["hbm_bytes_per_s"],
                    f / PEAKS["fp32_grade_flops_per_s"])
                for f, b in (work.gram(n, pk), work.top_basis(n, pk)))
    assert share == pytest.approx(100.0 * bound / 1.25)
    assert 0 < share <= 100


def test_each_call_computes_the_top_basis(small_cell):
    """Calls (a) and (b) take the cohort the window's last call left out,
    so each computes a top basis, traced as its three stages."""
    ctx = _window_ctx(small_cell(CELL))
    for got in (spans.plain(ctx), spans.profiled(ctx)):
        assert [s.attrs["source"] for s in got.spans
                if s.name == "eigen"] == ["computed"]
        stages = [s.name for s in got.spans if s.name.startswith("lowrank.")]
        assert stages == ["lowrank.stream_gram", "lowrank.gram_eigh",
                          "lowrank.top_basis"]


def test_study_readers_on_the_cpu(small_cell):
    """The cell's host readers read finite values and its device ones read
    nothing on the CPU, as ``wtccc_dense_10k.study``'s do."""
    cell = small_cell(CELL)
    ctx = _window_ctx(cell)
    assert spec.reader("lambda_evals.study").read(ctx) > 0
    assert spec.reader("eigen_s.study").read(ctx) is None
    res = harness.run(CELL, SEED, 0.05, True, "cpu", cell,
                      log=lambda s: None)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(got) == {"lambda_evals.study"}
    assert math.isfinite(got["lambda_evals.study"]["value"])
    assert {m["name"] for m in cell.per_layer} == {
        "idle_share.study", "lambda_evals.study", "eigen_s.study",
        "idle_in_reml.study", *NEW}


def test_sound_run_is_correct(small_cell):
    res = harness.run(CELL, SEED, 0.05, False, "cpu", small_cell(CELL),
                      log=lambda s: None)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"study_s", "peak_device_gib", "setup_s"}


@pytest.mark.parametrize("fault", ["stuck_lambda", "stale_basis",
                                   "half_block", "altered_beta", "ml_tau"])
def test_fault_is_refused(small_cell, fault):
    # the stale basis shows from the window's first call, on the cohort
    # whose basis the set-up's one call did not leave
    with faults.plant(fault):
        res = harness.run(CELL, SEED, 0.05, fault == "altered_beta", "cpu",
                          small_cell(CELL), log=lambda s: None)
    assert not res["correct"], res["checks"]
