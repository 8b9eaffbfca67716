"""pygemma_tpu_torch -- the LMM-GWAS engine (GEMMA method) on PyTorch and CUDA.

A port of ``pygemma_tpu`` (JAX on a TPU) to one NVIDIA H100: the same
``pygemma(Y, X, W, K, ...)`` driver and table, with the fused per-SNP-lambda
Gram kernel written by hand in CUDA for Hopper
(``pygemma_tpu_torch/csrc/gram_kernel.cu``).  Entry points run on the card
by default; pass ``device="cpu"`` to run on the CPU.
"""

from .api import estimate_lambda, pygemma
from .config import GwasConfig

__all__ = ["pygemma", "estimate_lambda", "GwasConfig"]
