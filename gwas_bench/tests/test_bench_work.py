"""The frozen K1 work count equals the program's at every configuration's
launch shapes: the kernel's n is the kinship's explicit directions (a
low-rank kinship's SNPs, a dense one's samples), B the configuration's SNP
block and twice it, c its covariates.  A configuration added to
``BENCHMARK.json`` is checked at its own shapes."""

import json

import pytest

from conftest import BENCH, ROOT
from gwas_bench import spec


def _shapes():
    """(n, B, c) of each listed configuration's K1 launches, each once."""
    out = []
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        kin = cfg["kinship"]
        n = kin["snps"] if kin["type"] == "lowrank_grm" else cfg["n"]
        for B in (cfg["snp_block"], 2 * cfg["snp_block"]):
            if (n, B, cfg["c"]) not in out:
                out.append((n, B, cfg["c"]))
    return out


@pytest.mark.parametrize("n,B,c", _shapes())
@pytest.mark.parametrize("kmax,logh", [(3, False), (1, True)])
def test_frozen_work_count(n, B, c, kmax, logh):
    from pygemma_tpu_torch.ops import gram_kernel

    s = c + 1
    m = s * (s + 1) // 2
    assert spec.work("k1").flops_and_bytes(n, B, 1, m, s, kmax, logh) == \
        gram_kernel.flops_and_bytes(n, B, 1, m, s, kmax, logh)
