"""The result line's schema, the entry point's refusals, and that a run
loads no JAX and none of the JAX package."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, SEED
from gwas_bench import harness, spec

RUN = ["gwas_bench/run.py", "--workload", "wtccc_dense_10k.scan", "--seed", "1",
       "--seconds", "1", "--trace", "0"]


def _number(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool) \
        and math.isfinite(x)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(small_cell, trace):
    name = "ukb_synth_50k.scan"
    cell = small_cell(name)
    res = harness.run(name, SEED, 0.05, trace, "cpu", cell,
                      log=lambda s: None)
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    # whole calls: a traced run makes exactly one
    assert line["attempted"] > 0 and line["attempted"] % cell.config["p"] == 0
    assert not trace or line["attempted"] == cell.config["p"]
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = cell.per_layer if trace else cell.end_to_end
    for name_, m in line["metrics"].items():
        assert name_ in {w["name"] for w in want}
        assert _number(m["value"]) and m["unit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert {m["name"] for m in cell.end_to_end} == set(line["metrics"])
    for c in line["checks"].values():
        assert _number(c["value"]) and _number(c["limit"])
        assert c["value"] <= c["limit"]


def test_no_card_no_result():
    """With no card to be seen (none here, or the machine's hidden), a
    run prints no result and exits non-zero."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, *RUN], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_alone_does_not_run(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's own
    folder has no program to run: no result, a non-zero exit."""
    shutil.copytree(ROOT / "gwas_bench", tmp_path / "gwas_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, *RUN], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "pygemma_tpu_torch" in proc.stderr


def test_run_loads_no_jax(small_cell):
    """A whole run, in a process of its own: no module whose top-level
    name (before the first dot, taken whole) is JAX's or the JAX
    package's is loaded, and the port's longer name does not count."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.path.insert(0, {str(ROOT / 'gwas_bench' / 'tests')!r})\n"
        "from conftest import small\n"
        "from gwas_bench import harness, spec\n"
        "cell = small(spec.load_cell('ukb_synth_50k.scan'))\n"
        "res = harness.run(cell.name, 3, 0.05, True, 'cpu', cell,\n"
        "                  log=lambda s: None)\n"
        "assert res['correct']\n"
        "assert 'pygemma_tpu_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "pygemma_tpu.api",
                        types.ModuleType("pygemma_tpu.api"))
    monkeypatch.setitem(sys.modules, "jaxlib_helper",
                        types.ModuleType("jaxlib_helper"))
    assert harness.forbidden_modules() == ["pygemma_tpu"]


def test_every_cell_has_its_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        for m in cell.end_to_end:
            assert m["name"] in harness.E2E
