"""Synthetic GWAS dataset simulators.

Parity targets (re-derived, not ported):
  * reference tests/gen_sim.R:11-43 -- MAF-drawn genotypes with a chosen
    number of causal SNPs and PVE-controlled phenotype;
  * reference tests/test_pygemma.py:301-332 ``simulate_gwas_dataset`` --
    kinship-correlated phenotype via a polygenic random effect;
  * reference tests/test_pygemma.py:195-212 ``generate_test_matrices`` --
    random PSD kinship fixtures.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class SimData(NamedTuple):
    Y: np.ndarray  # (n,) phenotype
    X: np.ndarray  # (n, p) genotypes (standardized dosages)
    W: np.ndarray  # (n, c) covariates (intercept first)
    K: np.ndarray  # (n, n) kinship
    beta: np.ndarray  # (p,) true effects
    causal: np.ndarray  # causal SNP indices


def simulate_gwas(
    n: int = 1000,
    p: int = 5000,
    c: int = 3,
    n_causal: Optional[int] = None,
    pve: float = 0.4,
    h2_poly: float = 0.3,
    maf_range=(0.05, 0.5),
    seed: int = 0,
    standardize: bool = True,
    dtype=np.float32,
) -> SimData:
    """MAF-drawn genotypes + PVE-controlled phenotype with polygenic effect.

    ``pve``: fraction of phenotypic variance explained by causal SNPs;
    ``h2_poly``: additional variance from the kinship-correlated random
    effect (gen_sim.R's PVE knob split into sparse + polygenic components).
    """
    rng = np.random.default_rng(seed)
    maf = rng.uniform(*maf_range, size=p)
    X = rng.binomial(2, maf[None, :], size=(n, p)).astype(np.float64)
    if standardize:
        X = (X - X.mean(0)) / np.maximum(X.std(0), 1e-6)
    K = X @ X.T / p
    K += 1e-4 * np.eye(n)

    if n_causal is None:
        n_causal = max(1, p // 100)
    causal = rng.choice(p, size=n_causal, replace=False)
    beta = np.zeros(p)
    beta[causal] = rng.normal(size=n_causal)

    g = X @ beta
    g *= np.sqrt(pve) / max(g.std(), 1e-12)
    u = rng.multivariate_normal(np.zeros(n), K) if h2_poly > 0 else np.zeros(n)
    if h2_poly > 0:
        u *= np.sqrt(h2_poly) / max(u.std(), 1e-12)
    e = rng.normal(size=n)
    e *= np.sqrt(max(1.0 - pve - h2_poly, 1e-6)) / max(e.std(), 1e-12)
    y = g + u + e

    W = np.ones((n, c))
    if c > 1:
        W[:, 1:] = rng.normal(size=(n, c - 1))
    return SimData(
        Y=y.astype(dtype),
        X=X.astype(dtype),
        W=W.astype(dtype),
        K=K.astype(dtype),
        beta=beta.astype(dtype),
        causal=np.sort(causal),
    )


def random_psd_kinship(n: int, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Random PSD kinship (reference generate_test_matrices)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 2 * n))
    K = A @ A.T / (2 * n)
    return K.astype(dtype)
