"""BIMBAM mean-genotype format reader/writer.

Format (as written by the reference's GEMMA bridge, tests/gemma_utils.py:218-
241): one SNP per row, comma- or whitespace-separated:

    rs123, A, T, g_1, g_2, ..., g_n

with genotypes in [0, 2].  Phenotype files are one value per line; covariate
files are whitespace-separated matrices; kinship files are dense n x n
matrices (GEMMA ``-k`` input).  Host-side NumPy only.
"""

from __future__ import annotations

import gzip
from typing import List, Optional, Tuple

import numpy as np


def _open(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_geno(path: str, missing: str = "NA") -> Tuple[np.ndarray, List[str]]:
    """Read a BIMBAM mean-genotype file -> (X (n, p) float32, snp names).

    Missing entries become NaN (impute downstream;
    ``pygemma_tpu_torch.preprocess.mean_impute``).
    """
    names: List[str] = []
    rows: List[np.ndarray] = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = [p.strip() for p in line.replace(",", " ").split()]
            names.append(parts[0])
            rows.append(np.array(
                [np.nan if v == missing else float(v) for v in parts[3:]],
                dtype=np.float32))
    X = np.stack(rows, axis=1)  # (n, p): samples x SNPs
    return X, names


def write_geno(path: str, X: np.ndarray, names: Optional[List[str]] = None,
               a1: str = "A", a2: str = "T") -> None:
    """Write (n, p) genotypes as BIMBAM rows (one per SNP)."""
    n, p = X.shape
    if names is None:
        names = [f"rs{i}" for i in range(p)]
    with _open(path, "wt") as f:
        for j in range(p):
            vals = ", ".join(
                "NA" if np.isnan(v) else f"{v:.6g}" for v in X[:, j])
            f.write(f"{names[j]}, {a1}, {a2}, {vals}\n")


def read_pheno(path: str, missing: str = "NA") -> np.ndarray:
    """One phenotype value per line (GEMMA -p); NA -> NaN."""
    vals = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            first = line.split()[0]
            vals.append(np.nan if first == missing else float(first))
    return np.asarray(vals, dtype=np.float32)


def write_pheno(path: str, y: np.ndarray) -> None:
    with _open(path, "wt") as f:
        for v in np.asarray(y).reshape(-1):
            f.write(("NA" if np.isnan(v) else f"{v:.10g}") + "\n")


def read_matrix(path: str) -> np.ndarray:
    """Dense whitespace-separated matrix (covariates W, kinship K)."""
    with _open(path) as f:
        return np.loadtxt(f, dtype=np.float32)


def write_matrix(path: str, M: np.ndarray) -> None:
    with _open(path, "wt") as f:
        np.savetxt(f, np.asarray(M), fmt="%.10g")
