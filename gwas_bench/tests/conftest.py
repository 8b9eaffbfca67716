"""Shared helpers of the benchmark's CPU tests: the cells of
``BENCHMARK.json`` and their configurations, shrunk to sizes a test run
holds."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gwas_bench import spec  # noqa: E402

SMALL = {"lowrank_grm": dict(n=800, p=1536, snp_block=512, snps=192),
         "dense_grm": dict(n=500, p=1024, snp_block=256)}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: every cell of the benchmark, in its order: a new workload entry is a new
#: case of each test parametrized by it
CELLS = tuple(w["name"] for w in BENCH["workloads"])
SEED = 2 ** 31 + 12345  # past 32 signed bits, as a run's seed may be


def small(cell: spec.Cell) -> spec.Cell:
    """``cell`` at a test's size: fewer samples, SNPs and kinship SNPs;
    every other setting as the configuration states."""
    cfg = dict(cell.config)
    size = SMALL[cfg["kinship"]["type"]]
    for key in ("n", "p", "snp_block"):
        cfg[key] = size[key]
    if "snps" in size:
        cfg["kinship"] = dict(cfg["kinship"], snps=size["snps"])
    cfg["phenotype"] = dict(cfg["phenotype"],
                            causal=min(cfg["phenotype"]["causal"], 20))
    return cell._replace(config=cfg)


@pytest.fixture
def small_cell():
    return lambda name: small(spec.load_cell(name))


@pytest.fixture(autouse=True)
def _empty_eigen_cache():
    """Every test leaves the program's one-entry eigen cache empty: cells
    share cohorts (the scan cells' is the study cell's first), and a test
    that holds a table to the bit computes its basis at its own thread
    count, so no test may find one that another left."""
    from pygemma_tpu_torch import api

    yield
    api._EIGEN_DEV_CACHE.clear()
