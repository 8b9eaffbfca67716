"""The timed path broken underneath: every run drives the rest of the
harness (on the CPU, past its look for a card) and ``correct`` must come
out false, once for each fault a cell can have (``faults.py``).  The
four-card cell's faults, the exchange between cards left out among them,
are planted in its ranks through the launcher (``test_bench_ranks.py``)."""

import pytest

from conftest import SEED
from gwas_bench import faults, harness


def _run(small_cell, name, trace=False, seconds=0.05):
    return harness.run(name, SEED, seconds, trace, "cpu", small_cell(name),
                       log=lambda s: None)


@pytest.mark.parametrize("name", ["ukb_synth_50k.scan", "wtccc_dense_10k.study",
                                  "ukb_synth_50k.pheno4"])
def test_sound_run_is_correct(small_cell, name):
    assert _run(small_cell, name)["correct"]


@pytest.mark.parametrize("fault,name", [
    ("stuck_lambda", "ukb_synth_50k.scan"),
    ("stuck_lambda", "wtccc_dense_10k.scan"),
    ("stale_basis", "wtccc_dense_10k.study"),
    ("half_block", "ukb_synth_50k.scan"),
    ("half_block", "ukb_synth_50k.pheno4"),
    ("altered_beta", "ukb_synth_50k.pheno4"),
    ("altered_beta", "wtccc_dense_10k.scan"),
    ("ml_tau", "ukb_synth_50k.scan"),
    ("ml_tau", "wtccc_dense_10k.study"),
])
def test_fault_is_refused(small_cell, fault, name):
    # the stale basis shows from the window's first call, on the cohort
    # whose basis the set-up's one call did not leave
    with faults.plant(fault):
        res = _run(small_cell, name, trace=fault == "altered_beta",
                   seconds=1.0 if fault == "stale_basis" else 0.05)
    assert not res["correct"], res["checks"]


def test_missing_answers_fail(small_cell, monkeypatch):
    """A table short of a row counts the call's answers as failed, and the
    judged row it lacks is NaN."""
    real = harness.Program.call

    def short(self, i):
        out = real(self, i)
        return {k: v[:, :-1] for k, v in out.items()}

    monkeypatch.setattr(harness.Program, "call", short)
    res = _run(small_cell, "wtccc_dense_10k.scan", trace=True)
    assert not res["correct"]
    assert res["failed"] == res["attempted"]
