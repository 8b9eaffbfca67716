"""The compute device of an entry point, and the matmul precision the scan
needs on it."""

from __future__ import annotations

import numpy as np
import torch


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a NumPy dtype (or anything ``np.dtype`` takes)."""
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def check_matmul_precision() -> None:
    """Refuse to run with TF32 matmuls: the REML scalars cancel badly, and
    the JAX package holds every matmul to float32 grade (Precision.HIGH)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    if tf32 or precision != "highest":
        raise RuntimeError(
            "the LMM scan needs full float32 matmuls, but "
            f"torch.backends.cuda.matmul.allow_tf32 is {tf32} and "
            f"torch.get_float32_matmul_precision() is {precision!r} "
            "(want False and 'highest')")


def resolve_device(device) -> torch.device:
    """The compute device; CUDA unless the caller asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    check_matmul_precision()
    return dev
