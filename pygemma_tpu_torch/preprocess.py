"""Phenotype/genotype preprocessing: imputation, standardization, qnorm, PCs.

Host-side NumPy/SciPy.  Reference equivalents re-derived (not ported): mean
imputation (experiments/animal_gwas/run_gwas.py:92-96), column
standardization and quantile normalization (tests/test_pygemma.py:411-414),
PCA covariates from the genotype matrix (tests/test_pygemma.py:402-405, via
sklearn there; here an SVD), zero-variance SNP QC
(experiments/wtccc/run_pygemma.py:407-410).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import stats


def mean_impute(X: np.ndarray) -> np.ndarray:
    """Replace NaNs with the per-SNP (column) mean; all-NaN columns -> 0."""
    X = np.array(X, dtype=np.float32, copy=True)
    mask = np.isnan(X)
    if mask.any():
        with np.errstate(invalid="ignore"):
            col_mean = np.nanmean(X, axis=0)
        col_mean = np.where(np.isnan(col_mean), 0.0, col_mean)
        X[mask] = np.take(col_mean, np.nonzero(mask)[1])
    return X


def standardize(X: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """(x - mean) / std per column (tests/test_pygemma.py:411)."""
    mu = X.mean(axis=0, keepdims=True)
    sd = X.std(axis=0, keepdims=True)
    if eps:
        sd = np.maximum(sd, eps)
    return (X - mu) / sd


def drop_zero_variance(X: np.ndarray, names=None, eps: float = 0.0
                       ) -> Tuple[np.ndarray, Optional[list], np.ndarray]:
    """QC: remove constant SNP columns (experiments/wtccc/run_pygemma.py:407-410)."""
    keep = X.std(axis=0) > eps
    Xk = X[:, keep]
    nk = [n for n, k in zip(names, keep) if k] if names is not None else None
    return Xk, nk, keep


def quantile_normalize(y: np.ndarray) -> np.ndarray:
    """Rank-based inverse-normal transform of a phenotype vector."""
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    ranks = stats.rankdata(y, method="average")
    return stats.norm.ppf(ranks / (len(y) + 1)).astype(np.float32)


def pca_covariates(X: np.ndarray, n_pcs: int = 5,
                   standardize_first: bool = True) -> np.ndarray:
    """Top principal components of the (standardized) genotype matrix.

    Returns (n, n_pcs) sample scores for use as covariates (the reference
    uses sklearn PCA, tests/test_pygemma.py:402-405).
    """
    Xs = standardize(X, eps=1e-6) if standardize_first else X - X.mean(0)
    # scores = left singular vectors scaled by singular values
    U, s, _ = np.linalg.svd(Xs, full_matrices=False)
    return (U[:, :n_pcs] * s[:n_pcs]).astype(np.float32)


def genomic_control_lambda(pvals: np.ndarray) -> float:
    """lambda_GC: median chi^2(1) of the observed p-values over 0.456
    (experiments/animal_gwas/run_gwas.py:185)."""
    p = np.asarray(pvals, dtype=np.float64)
    p = p[np.isfinite(p)]
    chi2 = stats.chi2.isf(p, df=1)
    return float(np.median(chi2) / stats.chi2.isf(0.5, df=1))
