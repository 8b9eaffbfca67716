"""Raw float32 binary matrices with a ``.dim`` sidecar.

Parity with the reference's large-GWAS ingest
(experiments/large_gwas/run_pygemma.py:34-46 and run_pygemma_base.py:35-44):
``<name>.bin`` holds row-major float32, ``<name>.dim`` holds "rows cols".
Memmap-backed so 20 GB genotype matrices stream block-wise to the device
without a host copy.  The ``.dim`` sidecar is shared by the packed and int8
formats (io/packed.py, io/quantized.py).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def read_dim(path: str) -> Tuple[int, int]:
    with open(path) as f:
        parts = f.read().split()
    return int(parts[0]), int(parts[1])


def read_rawbin(prefix: str, mmap: bool = True) -> np.ndarray:
    rows, cols = read_dim(prefix + ".dim")
    if mmap:
        return np.memmap(prefix + ".bin", dtype=np.float32, mode="r",
                         shape=(rows, cols))
    data = np.fromfile(prefix + ".bin", dtype=np.float32)
    return data.reshape(rows, cols)


def write_rawbin(prefix: str, M: np.ndarray) -> None:
    M = np.ascontiguousarray(M, dtype=np.float32)
    M.tofile(prefix + ".bin")
    with open(prefix + ".dim", "w") as f:
        f.write(f"{M.shape[0]} {M.shape[1] if M.ndim > 1 else 1}\n")


def read_eigenvalues(path: str) -> np.ndarray:
    """Eigenvalue file as consumed by the reference's eigen=False path
    (experiments/large_gwas/run_pygemma.py:44-46): one value per line."""
    return np.loadtxt(path, dtype=np.float32).reshape(-1)
