"""Kinship (genetic relatedness) matrix builders, on the device.

Reference equivalents: centered K = X_c X_c' / p used throughout
(experiments/wtccc/run_pygemma.py:445, tests/test_pygemma.py:184-192) and the
GCTA/GEMMA "-gk 2" standardized variant.  The n x n Gram is one plain GEMM,
which the JAX package leaves to XLA outside any Pallas kernel; here it is
``torch.matmul`` in full float32 (:func:`~pygemma_tpu_torch.device.resolve_device`
refuses TF32).  The GCTA binary GRM reader and writer are host NumPy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _centered(X: torch.Tensor, standardize: bool,
              eps: float) -> torch.Tensor:
    Xc = X - X.mean(dim=0, keepdim=True)
    if standardize:
        Xc = Xc / torch.clamp_min(X.std(dim=0, keepdim=True, correction=0),
                                  eps)
    return Xc


def _on_device(X, device) -> torch.Tensor:
    dev = resolve_device(device)
    if isinstance(X, torch.Tensor):
        return X.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(X, dtype=np.float32)).to(dev)


def centered_kinship(X, device="cuda") -> torch.Tensor:
    """GEMMA -gk 1: K = (X - mean) (X - mean)' / p, on ``device``."""
    Xd = _on_device(X, device)
    Xc = _centered(Xd, False, 0.0)
    return (Xc @ Xc.T) / Xd.shape[1]


def standardized_kinship(X, eps: float = 1e-6,
                         device="cuda") -> torch.Tensor:
    """GEMMA -gk 2: columns centered and scaled to unit variance first."""
    Xd = _on_device(X, device)
    Xs = _centered(Xd, True, eps)
    return (Xs @ Xs.T) / Xd.shape[1]


def kinship_blocked(X: np.ndarray, block: int = 8192,
                    standardize: bool = False, device="cuda") -> np.ndarray:
    """Accumulate K over SNP blocks for genotype matrices larger than the
    card's memory.

    Streams (n, b) float32 blocks host->device and accumulates the n x n
    Gram there; returns K / p as a host array.  The device-side analogue
    of the reference's out-of-core kinship handling
    (experiments/benchmarks/matrix_reader.cpp).
    """
    dev = resolve_device(device)
    n, p = X.shape
    K = torch.zeros((n, n), dtype=torch.float32, device=dev)
    for s in range(0, p, block):
        xb = torch.as_tensor(
            np.asarray(X[:, s:s + block], dtype=np.float32)).to(dev)
        xb = _centered(xb, standardize, 1e-6)
        K.addmm_(xb, xb.T)
    return (K / p).cpu().numpy()


def write_gcta_grm(prefix: str, K: np.ndarray, sample_ids=None,
                   n_snps: int = 0) -> None:
    """Write K in GCTA binary GRM format (.grm.bin/.grm.N.bin/.grm.id).

    The rival-benchmark seam the reference drives from R
    (experiments/benchmarks/subsample.R:98-110 times ``gcta --mlma`` against
    a GRM): float32 lower triangle incl. diagonal in (i, j<=i) order, a
    per-pair SNP-count file, and FID/IID lines.
    """
    K = np.asarray(K, np.float32)
    n = K.shape[0]
    sample_ids = sample_ids or [f"id{i}" for i in range(n)]
    idx = np.tril_indices(n)
    # tril_indices is row-major over (i, j<=i) -- exactly GCTA's pair order
    with open(prefix + ".grm.bin", "wb") as f:
        f.write(np.ascontiguousarray(K[idx], np.float32).tobytes())
    with open(prefix + ".grm.N.bin", "wb") as f:
        f.write(np.full(len(idx[0]), max(n_snps, 1), np.float32).tobytes())
    with open(prefix + ".grm.id", "w") as f:
        for i, sid in enumerate(sample_ids):
            f.write(f"fam{i}\t{sid}\n")


def read_gcta_grm(prefix: str) -> np.ndarray:
    """Read a GCTA binary GRM back into a dense symmetric (n, n) matrix."""
    with open(prefix + ".grm.id") as f:
        n = sum(1 for line in f if line.strip())
    with open(prefix + ".grm.bin", "rb") as f:
        vals = np.frombuffer(f.read(), np.float32)
    K = np.zeros((n, n), np.float32)
    idx = np.tril_indices(n)
    K[idx] = vals
    K[(idx[1], idx[0])] = vals
    return K
