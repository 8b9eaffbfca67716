"""What a cell is, read from data files found by name.

``BENCHMARK.json`` (the repository's root) names each cell's configuration
and traffic mix and lists the metrics each cell reports.  Everything that
belongs to one configuration, traffic mix, cell or per-layer metric sits
in a file of its own under this folder:

- ``configs/<config>.json``: the cohort's sizes, genotype and kinship
  recipe, and the guarantees the scan keeps;
- ``traffic/<traffic>.json``: phenotypes per call, cohorts the calls
  take turns over and, for a cell on more than one card, the ``mesh``
  (``snp`` and ``sample`` ranks) its ``pygemma`` calls run on;
- ``limits/<cell>.json``: the comparison's limits, with the readings they
  were set from;
- ``metrics/<metric>.py``, or ``metrics/<name before the first dot>.py``
  for a quantity split by cell kind: the reader of a per-layer metric;
- ``work/<kernel>.py``: a kernel's operations and bytes.

So a new configuration, mix, cell or metric is new files and entries, and
no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import NamedTuple, Optional

HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list
    chips: int = 1  # cards, one process each when more than 1


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = HERE.parent,
              here: Path = HERE) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return Cell(name, _json(here / "configs" / f"{w['config']}.json"),
                _json(here / "traffic" / f"{w['traffic']}.json"),
                _json(here / "limits" / f"{name}.json"),
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)],
                w["chips"])


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "gwas_bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, here: Path = HERE) -> ModuleType:
    """The module whose ``read(ctx)`` gives ``metric``."""
    for stem in (metric, metric.split(".")[0]):
        path = here / "metrics" / f"{stem}.py"
        if path.exists():
            return _module(path)
    raise SystemExit(f"no reader for metric {metric!r} under metrics/")


def work(kernel: str, here: Path = HERE) -> ModuleType:
    return _module(here / "work" / f"{kernel}.py")


def peaks(device_name: str, here: Path = HERE) -> Optional[dict]:
    """The card's published peaks (``peaks.json``), or None when the table
    does not hold the card."""
    return _json(here / "peaks.json").get(device_name)
