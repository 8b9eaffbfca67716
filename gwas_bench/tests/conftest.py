"""Shared helpers of the benchmark's CPU tests: the cells shrunk to sizes a
test run holds."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gwas_bench import spec  # noqa: E402

SMALL = {"lowrank_grm": dict(n=800, p=1536, snp_block=512, snps=192),
         "dense_grm": dict(n=500, p=1024, snp_block=256)}
CELLS = ("ukb_synth_50k.scan", "wtccc_dense_10k.study",
         "ukb_synth_50k.pheno4", "wtccc_dense_10k.scan",
         "ukb_synth_50k.mesh4")
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
