"""PLINK .traw (transposed raw dosage) and generic CSV/TSV genotype readers.

The reference loads its GD449/mouse fixtures from .traw-style tables with
pandas (tests/test_pygemma.py:363-364); parity here plus gzip support.
.traw layout: header ``CHR SNP (C)M POS COUNTED ALT <sample ids...>``, one
SNP per row.  Host-side pandas/NumPy only.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import pandas as pd


class TrawData(NamedTuple):
    X: np.ndarray  # (n, p) float32, NaN = missing
    snp_ids: List[str]
    sample_ids: List[str]
    chrom: np.ndarray
    pos: np.ndarray


def read_traw(path: str) -> TrawData:
    df = pd.read_csv(path, sep=r"\s+", compression="infer")
    meta_cols = [c for c in ("CHR", "SNP", "(C)M", "CM", "POS", "COUNTED",
                             "ALT") if c in df.columns]
    sample_cols = [c for c in df.columns if c not in meta_cols]
    X = df[sample_cols].to_numpy(dtype=np.float32).T  # (n, p)
    return TrawData(
        X=X,
        snp_ids=(df["SNP"].astype(str).tolist() if "SNP" in df
                 else [f"snp{i}" for i in range(X.shape[1])]),
        sample_ids=[str(c) for c in sample_cols],
        chrom=df["CHR"].to_numpy() if "CHR" in df else np.zeros(X.shape[1]),
        pos=df["POS"].to_numpy() if "POS" in df else np.arange(X.shape[1]),
    )


def read_csv_genotypes(path: str, sample_axis: str = "rows",
                       **kw) -> Tuple[np.ndarray, List[str]]:
    """Generic CSV/TSV numeric genotype table -> ((n, p) float32, names)."""
    df = pd.read_csv(path, **kw)
    num = df.select_dtypes("number")
    X = num.to_numpy(dtype=np.float32)
    if sample_axis == "cols":
        X = X.T
        names = df.iloc[:, 0].astype(str).tolist() if df.shape[1] else []
    else:
        names = [str(c) for c in num.columns]
    return X, names
