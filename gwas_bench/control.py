"""Readings that the comparison's limits are set from, in one process.

    python3 gwas_bench/control.py --workload <cell> --seeds 1,2,3 \\
        --side program|tf32 [--fault <name>]

For each seed the cell's cohorts are drawn as a run draws them.  With
``--side program`` the program makes one call on each cohort and the judge
reads those tables as a run does (a warm call returns the table of a cold
one): these are the lower readings.  With ``--side tf32`` the plain
reference, computed in TF32 (float32 with every product's operands
rounded to 10 mantissa bits), is put in the program's place for the
rows a run judges (a stratified sample and each cohort's most significant
rows, found by a plain screen): this is the control, whose readings have
to come out above the limits.  ``--fault``
plants one of ``faults.py``'s faults in the program first.  One JSON line
per seed, then the largest (program) or smallest (control, fault) reading
of each number.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gwas_bench import cohorts as gen  # noqa: E402
from gwas_bench import faults, harness, judge, spec  # noqa: E402
from gwas_bench.reference import lmm  # noqa: E402


def program_readings(cell: spec.Cell, seed: int, device) -> dict:
    cfg, traffic = cell.config, cell.traffic
    k, p = traffic["phenotypes"], cfg["p"]
    cohorts = gen.make_cohorts(cfg, traffic, seed, device)
    prog = harness.Program(cfg, cohorts, device)
    calls = [judge.Call(i, prog.call(i)) for i in range(len(cohorts))]
    del prog
    rng = np.random.default_rng(gen.derive(seed, "judge"))
    rows = judge.sample(calls, k, p, cfg["snp_block"], rng)
    per_row = judge.compare(calls, cohorts, cfg, rows, device)
    return judge.summary(per_row, judge.failed(calls, k, p))


def strongest(co, k: int, p: int, device, block: int = 4096) -> list:
    """A cohort's ``judge.TOP_HITS`` most significant (phenotype, SNP)
    rows by a plain float64 screen (|X'y| of the standardized SNPs and
    the centred phenotypes), the rows a run judges as its top hits."""
    Y = torch.as_tensor(co.Y).to(device, torch.float64)
    Y = Y - Y.mean(0)
    score = torch.empty(k, p, dtype=torch.float64, device=device)
    for s in range(0, p, block):
        X = co.columns(np.arange(s, min(s + block, p)), device)
        score[:, s:s + X.shape[1]] = (Y.T @ X).abs()
        del X
    flat = torch.topk(score.flatten(), judge.TOP_HITS).indices.cpu().numpy()
    return [(int(i // p), int(i % p)) for i in flat]


def control_readings(cell: spec.Cell, seed: int, device,
                     precision: str) -> dict:
    """The reference in ``precision`` in the program's place, judged on
    the rows a one-call run judges: a stratified sample of each cohort's
    rows and its most significant rows."""
    cfg, traffic = cell.config, cell.traffic
    k, p, block = traffic["phenotypes"], cfg["p"], cfg["snp_block"]
    cohorts = gen.make_cohorts(cfg, traffic, seed, device)
    rng = np.random.default_rng(gen.derive(seed, "judge"))
    n_blocks = -(-p // block)
    per = max(1, math.ceil(judge.ROWS_PER_COHORT / n_blocks))
    out = {name: [] for name in judge.NUMBERS}
    for co in cohorts:
        snps = np.concatenate([rng.integers(b * block,
                                            min((b + 1) * block, p), per)
                               for b in range(n_blocks)])
        phs = rng.integers(0, k, snps.size)
        top = strongest(co, k, p, device)
        snps = np.concatenate([snps, [snp for _, snp in top]])
        phs = np.concatenate([phs, [ph for ph, _ in top]])
        W = torch.as_tensor(co.W).to(device)
        X = co.columns(snps, device)
        Y = torch.as_tensor(co.Y[:, phs]).to(device)
        space = judge.eigenspace(co, cfg, device, precision)
        got = lmm.scan(space, W, X, Y)
        del space
        ref = judge.eigenspace(co, cfg, device, "float64")
        res = lmm.judge(ref, W, X, Y, got)
        del ref
        for name in judge.NUMBERS:
            out[name].append(res[name])
    per_row = {name: np.concatenate(v) for name, v in out.items()}
    return judge.summary(per_row, 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", choices=("program", "tf32"), required=True)
    ap.add_argument("--fault", choices=faults.NAMES)
    args = ap.parse_args()
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda")
    seen = []
    side = args.fault or args.side
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.side == "program":
            with (faults.plant(args.fault) if args.fault
                  else contextlib.nullcontext()):
                r = program_readings(cell, seed, dev)
        else:
            r = control_readings(cell, seed, dev, args.side)
        seen.append(r)
        print(json.dumps({"workload": args.workload, "side": side,
                          "seed": seed, **r}), flush=True)
    pick = max if side == "program" else min
    print(json.dumps({"workload": args.workload, "side": side,
                      "seeds": len(seen),
                      **{name: pick(r[name] for r in seen)
                         for name in judge.NUMBERS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
