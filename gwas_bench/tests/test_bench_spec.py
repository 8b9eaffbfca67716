"""Cells, configurations, traffic mixes, limits and metric readers are
found by name, and a new cell or metric is new files and entries only."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT
from gwas_bench import judge, spec


def test_benchmark_names_every_file():
    """Every workload names a listed configuration, a traffic mix and a
    limits file that exist where ``spec.load_cell`` looks for them, and is
    called ``<config>.<traffic>``; every per-layer metric has a reader."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["gwas_bench"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"gwas_bench/configs/{c['name']}.json"
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    assert CELLS and len(set(CELLS)) == len(CELLS)
    for w in bench["workloads"]:
        assert w["config"] in configs, w["name"]
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (spec.HERE / "limits" / f"{w['name']}.json").exists()
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in bench["per_layer"]:
        spec.reader(m["name"])  # raises if the metric has no reader


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["snp_block"] > 0
    assert cell.traffic["phenotypes"] >= 1
    ranks = {"rank_mismatch"} if cell.chips > 1 else set()
    assert set(cell.limits) == set(judge.NUMBERS) | {"failed"} | ranks
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 3
    assert cell.per_layer
    # every per-layer metric moves an end-to-end metric this cell reports
    assert all(m["moves"] in names for m in cell.per_layer)


def test_reader_falls_back_to_the_quantity():
    assert spec.reader("idle_share.scan").__file__.endswith("idle_share.py")
    with pytest.raises(SystemExit):
        spec.reader("no_such_metric.scan")


def _digest(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    """A cell of a new configuration and a new per-layer metric, added to
    a copy as new files plus entries in BENCHMARK.json, are picked up by
    the copy's own harness, and no file it had changes."""
    shutil.copytree(ROOT / "gwas_bench", tmp_path / "gwas_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "gwas_bench")
    g = tmp_path / "gwas_bench"
    cfg = json.loads((g / "configs" / "wtccc_dense_10k.json").read_text())
    cfg.update(n=300, p=512, snp_block=128)
    cfg["phenotype"] = dict(cfg["phenotype"], causal=5)
    (g / "configs" / "tiny_dense.json").write_text(json.dumps(cfg))
    (g / "traffic" / "pheno3.json").write_text(
        json.dumps({"phenotypes": 3, "cohorts": 1}))
    # a test's cell: its limits only have to admit a sound run
    (g / "limits" / "tiny_dense.pheno3.json").write_text(json.dumps(
        {k: {"limit": 1e-2} for k in judge.NUMBERS}
        | {"failed": {"limit": 0}}))
    (g / "metrics" / "blocks_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.blocks)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="tiny_dense",
                                 file="gwas_bench/configs/tiny_dense.json"))
    bench["workloads"].append({"name": "tiny_dense.pheno3",
                               "config": "tiny_dense", "traffic": "pheno3",
                               "chips": 1, "why": "a test's cell"})
    bench["end_to_end"][0]["workloads"].append("tiny_dense.pheno3")
    bench["per_layer"].append({
        "name": "blocks_seen", "unit": "blocks", "better": "higher",
        "source": "program_counter", "layer": "api", "moves":
        "snp_tests_per_s", "workloads": ["tiny_dense.pheno3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(g)
    assert all(after[k] == v for k, v in before.items())

    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from gwas_bench import harness\n"
        f"assert harness.__file__.startswith({str(tmp_path)!r})\n"
        "out = {t: harness.run('tiny_dense.pheno3', 7, 0.1, t, 'cpu',\n"
        "                      log=lambda s: None) for t in (False, True)}\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["false"]["correct"] and out["true"]["correct"]
    assert out["false"]["metrics"]["snp_tests_per_s"]["value"] > 0
    assert out["true"]["metrics"]["blocks_seen"]["value"] == 4.0
