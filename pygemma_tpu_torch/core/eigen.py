"""Kinship eigendecomposition and eigenbasis rotation.

Reference behaviour being reproduced (lmm/lmm.py:151-167, 196-211, 243-246):
``eigh(K)``, clamp eigenvalues at zero, rotate X/Y/W by U'.  The
``eigen=False`` path accepts a precomputed eigenvalue vector with
already-rotated inputs (the reference's external-eigendecomposition seam,
experiments/large_gwas/run_pygemma.py:44-65).

On the card the eigh is ``torch.linalg.eigh`` (cuSOLVER); a SNP block's
rotation is the hand-written 3xTF32 kernel of
:mod:`pygemma_tpu_torch.ops.rotate_kernel`, the narrow rotations of W and Y
a float32 ``torch.matmul`` with TF32 off.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..ops import rotate_kernel
from ..utils import profiling
from .eigh_dc import eigh_dc


def eigendecompose(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition with the reference's eigenvalue clamp.

    Returns (eigenvalues (n,), eigenvectors U (n, n)) on K's device, with
    eigenvalues clamped at 0 (reference lmm/lmm.py:157).
    """
    ev, U = torch.linalg.eigh(K)
    return torch.clamp_min(ev, 0.0), U


def rotate(U: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Rotate columns of M into the eigenbasis: U' M (lmm/lmm.py:243-246),
    by :func:`pygemma_tpu_torch.ops.rotate_kernel.rotate` (the kernel for a
    float32 SNP block on the card).  Traced as a ``rotate`` span of U'
    (r, n) times M (n, B)."""
    with profiling.span("rotate", U.device, r=U.shape[1], n=U.shape[0],
                        B=M.shape[1] if M.ndim == 2 else 1):
        return rotate_kernel.rotate(U, M)


def loading_transform(Z: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Random-effect loading transform K <- Z K Z' (lmm/lmm.py:124-125)."""
    return torch.matmul(torch.matmul(Z, K), Z.T)


def host_eigendecompose(K, dtype=None) -> Tuple[np.ndarray, np.ndarray]:
    """LAPACK eigh on the host CPU with the same eigenvalue clamp.

    Used when the card cannot hold the device eigh's workspace.  Returns
    host (NumPy) arrays; the caller moves them to the device once.
    """
    Kh = torch.as_tensor(np.ascontiguousarray(np.asarray(K)))
    evt, Ut = torch.linalg.eigh(Kh)
    ev, U = np.maximum(evt.numpy(), 0.0), Ut.numpy()
    if dtype is not None:
        ev = ev.astype(dtype)
        U = U.astype(dtype)
    return ev, U


#: cuSOLVER's syevd holds K, U and a workspace of about 2 n^2 values; with
#: the caller's copy of K and headroom, admit the device eigh at this many
#: n x n matrices of free memory
_DEVICE_EIGH_MATRICES = 6


def device_eigh_fits(n: int, itemsize: int, device) -> bool:
    """Whether the card's free memory holds the device eigh's workspace."""
    free, _ = torch.cuda.mem_get_info(device)
    return _DEVICE_EIGH_MATRICES * n * n * itemsize <= free


def auto_eigendecompose(K, backend: str = "auto", dtype=None,
                        device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecompose K and return (ev, U) as tensors on ``device`` (the
    card unless the caller asks for the CPU; without a card it raises).

    ``K`` is a host array or a tensor; a tensor already on ``device`` (the
    low-rank path's p_k x p_k Gram) is decomposed there without a trip
    through the host.  "device" runs ``torch.linalg.eigh`` on ``device``;
    "host" runs LAPACK on the host and copies the result over; "dc" runs the
    spectral divide and conquer (:func:`.eigh_dc.eigh_dc`) on ``device`` and
    raises if a split fails; "auto" takes the device eigh on a CPU device,
    and on a CUDA device when :func:`device_eigh_fits`, else the host.
    "auto" never takes "dc": cuSOLVER needs less memory for the same n.
    """
    device = resolve_device(device)
    if isinstance(K, torch.Tensor):
        Kt = K if dtype is None else K.to(torch_dtype(dtype))
    else:
        Kt = torch.as_tensor(np.asarray(K, dtype=dtype))
    if backend == "dc":
        ev, U = eigh_dc(Kt.to(device))
        return torch.clamp_min(ev, 0.0), U
    if backend not in ("auto", "device", "host"):
        raise ValueError(f"unknown eigh_backend {backend!r}")
    on_device = backend == "device" or (
        backend == "auto" and (
            device.type == "cpu"
            or device_eigh_fits(Kt.shape[0], Kt.element_size(), device)))
    if on_device:
        return eigendecompose(Kt.to(device))
    ev, U = host_eigendecompose(Kt.cpu().numpy(), dtype)
    return torch.as_tensor(ev).to(device), torch.as_tensor(U).to(device)
