"""Whether the window's tables are correct.

The answers judged are the window's own: a sample, drawn from the seed, of
the (call, phenotype, SNP) rows that its calls returned, stratified so
that every SNP block of every call gives rows, plus each cohort's most
significant rows (ranked by the program's |beta / se|, which ``z_err``
and ``se_err`` hold).  The plain reference (``reference/lmm.py``,
float64) works each sampled row out again from the cohort's own inputs
and reads the program's table (beta, se_beta, tau, lambda, F_wald, p_wald) only to
judge it:

- ``loglik_gap``: how far the REML likelihood at the program's lambda lies
  below its maximum (the reference's own lambda search), largest over the
  rows;
- ``z_err``: |beta - beta_ref| / se_ref at the program's lambda, largest;
- ``se_err``: |se / se_ref - 1| at the program's lambda, largest;
- ``tau_err``: |tau / tau_ref - 1| at the program's lambda, largest;
- ``f_err``: |sqrt(F_wald) - sqrt(F_ref)| (the Wald statistic's |z|) at
  the program's lambda, largest;
- ``p_err``: |log10 p_wald - log10 p_ref| / max(1, |log10 p_ref|) at the
  program's lambda, p_ref in float64, largest;
- ``failed``: rows the window returned that are not finite, or missing.

Each number is held to its limit in ``limits/<cell>.json``; a row that is
not finite makes every number NaN, and NaN is never within a limit.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .reference import lmm

#: rows judged per cohort, spread over its calls and SNP blocks
ROWS_PER_COHORT = 256
#: a cohort's most significant rows, always judged
TOP_HITS = 8
NUMBERS = ("loglik_gap", "z_err", "se_err", "tau_err", "f_err", "p_err")
#: the table's columns that are read and judged
COLUMNS = ("beta", "se_beta", "tau", "lambda", "F_wald", "p_wald")


class Call(NamedTuple):
    cohort: int
    table: Dict[str, np.ndarray]  # column -> (k, p)


def failed(calls: List[Call], k: int, p: int) -> int:
    """Answers of the window that are missing or not finite."""
    bad = 0
    for c in calls:
        cols = [c.table[col] for col in COLUMNS]
        if any(a.shape != (k, p) for a in cols):
            bad += k * p
        else:
            bad += int((~np.all([np.isfinite(a) for a in cols], 0)).sum())
    return bad


def sample(calls: List[Call], k: int, p: int, block: int,
           rng: np.random.Generator) -> List[tuple]:
    """(call, phenotype, SNP) rows to judge."""
    n_blocks = -(-p // block)
    per_cohort = {}
    for c in calls:
        per_cohort[c.cohort] = per_cohort.get(c.cohort, 0) + 1
    picked = []
    for j, c in enumerate(calls):
        per = max(1, math.ceil(ROWS_PER_COHORT
                               / (per_cohort[c.cohort] * n_blocks)))
        for b in range(n_blocks):
            lo, hi = b * block, min((b + 1) * block, p)
            for snp, ph in zip(rng.integers(lo, hi, per),
                               rng.integers(0, k, per)):
                picked.append((j, int(ph), int(snp)))
    last = {c.cohort: j for j, c in enumerate(calls)}
    for j in last.values():
        t = calls[j].table
        z = np.nan_to_num(np.abs(t["beta"] / t["se_beta"]), nan=-1.0)
        flat = np.argsort(-z, axis=None)[:TOP_HITS]
        picked += [(j, int(i // p), int(i % p)) for i in flat]
    return picked


def compare(calls: List[Call], cohorts, cfg: dict, rows: List[tuple],
            device) -> Dict[str, np.ndarray]:
    """Per judged row, each number of ``NUMBERS``."""
    out = {name: [] for name in NUMBERS}
    for ci, co in enumerate(cohorts):
        mine = [r for r in rows if calls[r[0]].cohort == ci]
        if not mine:
            continue
        space = eigenspace(co, cfg, device, "float64")
        W = torch.as_tensor(co.W).to(device)
        got = {col: np.array([_answer(calls[j].table[col], ph, snp)
                              for j, ph, snp in mine])
               for col in COLUMNS}
        X = co.columns([snp for _, _, snp in mine], device)
        Y = torch.as_tensor(co.Y[:, [ph for _, ph, _ in mine]]).to(device)
        res = lmm.judge(space, W, X, Y, got)
        for name in NUMBERS:
            out[name].append(res[name])
        del space
    return {k: np.concatenate(v) for k, v in out.items()}


def _answer(a: np.ndarray, ph: int, snp: int) -> float:
    """A call's answer, NaN where its table has no such row."""
    try:
        return float(a[ph, snp])
    except IndexError:
        return math.nan


def eigenspace(co, cfg: dict, device, precision: str) -> lmm.Eigenspace:
    """K's eigenspace, worked out again from the cohort's own K or codes."""
    kin = cfg["kinship"]
    if kin["type"] == "lowrank_grm":
        G = co.columns(np.arange(kin["snps"]), device)
        return lmm.lowrank_eigenspace(G, kin["ridge"], precision)
    return lmm.dense_eigenspace(torch.as_tensor(co.K).to(device), precision)


def summary(per_row: Dict[str, np.ndarray], n_failed: int) -> Dict[str, float]:
    """The numbers compared: each the largest over the judged rows (NaN
    when any row is NaN), and the count of failed answers."""
    out = {name: float(np.max(v)) if v.size else math.nan
           for name, v in per_row.items()}
    out["failed"] = float(n_failed)
    return out


def verdict(numbers: Dict[str, float], limits: dict) -> bool:
    return all(numbers[name] <= limits[name]["limit"] for name in numbers)
