"""pygemma_tpu_torch -- the LMM-GWAS engine (GEMMA method) on PyTorch and CUDA.

A port of ``pygemma_tpu`` (JAX on a TPU) to one NVIDIA H100: the same
``pygemma(Y, X, W, K, ...)`` driver and table, with the fused per-SNP-lambda
Gram kernel written by hand in CUDA for Hopper
(``pygemma_tpu_torch/csrc/gram_kernel.cu``), and the ``python -m
pygemma_tpu_torch`` command line.  Entry points run on the card by default;
pass ``device="cpu"`` to run on the CPU.  ``parallel/`` shards the scan
over several cards (one process per rank, ``torch.distributed``).
"""

__version__ = "0.1.0"

from . import compare, io, linreg, plotting, preprocess, sim  # noqa: F401
from .api import estimate_lambda, pygemma
from .config import GwasConfig, from_env
from .core.lowrank import LowRankKinship

__all__ = [
    "pygemma",
    "estimate_lambda",
    "LowRankKinship",
    "GwasConfig",
    "from_env",
    "io",
    "linreg",
    "plotting",
    "preprocess",
    "sim",
    "__version__",
]
