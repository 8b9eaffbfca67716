"""The rotation of a SNP block into the eigenbasis, U' X: a hand-written CUDA
kernel.

Every scan rotates each SNP block (n, B) into the kinship's eigenbasis:
U' (r, n) times the block, r = n for a dense basis
(:func:`pygemma_tpu_torch.core.eigen.rotate`) and r = p_k for the implicit
path's top space (``api._rotate_top``).  It is the scan's largest GEMM.
``csrc/rotate_kernel.cu`` computes it on the tensor cores in 3xTF32, its
partial sums promoted to a round-to-nearest float32 sum every 128 samples;
the source says why it was added (it replaces no TPU kernel), what bounds it
and how its design answers that.

:func:`rotate` picks by device and shape alone: CPU tensors take the plain
version, :func:`rotate_plain` (``torch.matmul``); float32 CUDA tensors of a
shape the kernel takes (:func:`takes`: a block at least one tile wide, of
any r and n) launch it through :func:`rotate_kernel`, which raises on what
it cannot run and never falls back; other CUDA calls (the rotations of W
and Y, c or k columns wide: memory-bound GEMV-class products, which the JAX
package leaves to XLA too, and float64) stay on ``torch.matmul``.
``rotate_kernel.launches`` counts the launches.

U may lie row-major, (n, r) with the samples slow (the implicit top space),
or column-major (cuSOLVER's dense basis, whose transpose is row-major); the
block is row-major (n, B).  TMA reads rows of a whole number of 16 bytes
from a 16-byte boundary.  U is never copied: where its rows are not so
(:func:`u_by_tma`), the kernel reads it by 4-byte ``cp.async``.  A block
whose rows are not so is copied into a zero-padded scratch of its own size
(:func:`block_by_tma`), and C's padding columns dropped.

The library is built at first use with ``nvcc`` by
:func:`pygemma_tpu_torch.ops.gram_kernel.build` and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from . import gram_kernel

SOURCE = Path(gram_kernel.__file__).resolve().parent.parent / "csrc" / \
    "rotate_kernel.cu"
#: the source's tile: rows of C (columns of U) and columns of C (SNPs)
TILE_M, TILE_N = 128, 128
#: samples between promotions of the tensor cores' partial sums
PROMOTE_SAMPLES = 128
#: the float32-grade tensor-core rate: 495 TFLOP/s TF32 over three passes
PEAK_FLOPS = 165e12


def takes(r: int, n: int, B: int) -> bool:
    """Whether the kernel takes U' (r, n) times a block (n, B): a block at
    least one tile wide; r and n any size."""
    return B >= TILE_N and min(r, n) > 0


def u_by_tma(r: int, n: int, u_column_major: bool,
             aligned: bool = True) -> bool:
    """Whether TMA reads U: its rows (r floats row-major, n column-major)
    are a whole number of 16 bytes, from a 16-byte boundary (``aligned``:
    U's first byte).  Else the kernel reads U by cp.async."""
    return (n if u_column_major else r) % 4 == 0 and aligned


def block_by_tma(B: int, aligned: bool = True) -> bool:
    """Whether TMA reads the block as it is: its rows of B floats are a
    whole number of 16 bytes, from a 16-byte boundary (``aligned``: the
    block's first byte).  Else the wrapper copies it into a zero-padded
    scratch, B rounded up to a multiple of 4 columns."""
    return B % 4 == 0 and aligned


def rotate_plain(U: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """U' M by ``torch.matmul``: the kernel's plain version."""
    return torch.matmul(U.T, M)


def rotate(U: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """U' M: the plain version on the CPU, the kernel on float32 CUDA
    tensors of a shape it takes, ``torch.matmul`` otherwise."""
    if M.device.type == "cpu":
        return rotate_plain(U, M)
    if (U.ndim == 2 and M.ndim == 2 and U.dtype == torch.float32
            and M.dtype == torch.float32
            and takes(U.shape[1], U.shape[0], M.shape[1])):
        return rotate_kernel(U, M)
    return torch.matmul(U.T, M)


def bind(path: Path) -> ctypes.CDLL:
    """Load a built rotation library, declare its C interface and check
    that its tile is the wrapper's."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rotate_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.rotate_launch.restype = i
    for name in ("rotate_tile_m", "rotate_tile_n", "rotate_promote_samples"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    got = (lib.rotate_tile_m(), lib.rotate_tile_n(),
           lib.rotate_promote_samples())
    if got != (TILE_M, TILE_N, PROMOTE_SAMPLES):
        raise RuntimeError(f"{path.name}: tile and promotion {got}, the "
                           f"wrapper's are {(TILE_M, TILE_N, PROMOTE_SAMPLES)}")
    return lib


def _load() -> ctypes.CDLL:
    return gram_kernel._load(SOURCE, bind)


def rotate_kernel(U: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """U' X (r, B) by the kernel, for float32 CUDA tensors on one card: U
    (n, r), row-major or column-major, and X (n, B) row-major, of a shape
    :func:`takes`.  Raises on anything else.  A block whose rows TMA cannot
    read is copied into an aligned, zero-padded scratch (n, B + < 4)."""
    for name, t in (("U", U), ("X", X)):
        if t.dtype != torch.float32:
            raise ValueError(f"the rotation kernel takes float32; {name} is "
                             f"{t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"{name} must be a matrix, not {tuple(t.shape)}")
    n, r = U.shape
    if X.shape[0] != n:
        raise ValueError(f"U {tuple(U.shape)} and X {tuple(X.shape)} do not "
                         "share the sample axis")
    B = X.shape[1]
    if not takes(r, n, B):
        raise ValueError(f"the rotation kernel does not take r={r}, n={n}, "
                         f"B={B}")
    if not X.is_contiguous():
        raise ValueError("X must be row-major (contiguous)")
    u_kmajor = not U.is_contiguous()
    if u_kmajor and not U.T.is_contiguous():
        raise ValueError("U must be row-major or column-major")
    if U.device.type != "cuda" or U.device != X.device:
        raise ValueError(f"the rotation kernel runs on CUDA tensors on one "
                         f"card, not U on {U.device} and X on {X.device}")
    tma_u = u_by_tma(r, n, u_kmajor, U.data_ptr() % 16 == 0)
    pad = not block_by_tma(B, X.data_ptr() % 16 == 0)
    width = -(-B // 4) * 4
    lib = _load()
    index = X.device.index
    if index is None:
        index = torch.cuda.current_device()
    with torch.cuda.device(index):
        if pad:
            Xp = torch.zeros((n, width), dtype=torch.float32, device=X.device)
            Xp[:, :B] = X
            X = Xp
        C = torch.empty((r, width), dtype=torch.float32, device=X.device)
        err = lib.rotate_launch(
            U.data_ptr(), X.data_ptr(), C.data_ptr(), n, r, width,
            int(u_kmajor), int(tma_u), gram_kernel._sm_count(index),
            torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rotation kernel launch failed: error {err}")
    rotate_kernel.launches += 1
    return C[:, :B].contiguous() if width != B else C


rotate_kernel.launches = 0


def flops_and_bytes(r: int, n: int, B: int) -> Tuple[float, float]:
    """Work of one U' (r, n) x (n, B) product: a multiply-add per (row,
    sample, column); U, the block and C once, float32."""
    return 2.0 * r * n * B, 4.0 * (r * n + n * B + r * B)


def bound_ms(r: int, n: int, B: int) -> Tuple[float, str]:
    """Least time (ms) the card could take for one rotation, and what sets
    it: the operations at the float32-grade tensor-core rate, or the bytes
    at HBM's."""
    flops, nbytes = flops_and_bytes(r, n, B)
    return gram_kernel.bound_ms(flops, nbytes, peak_flops=PEAK_FLOPS)
