"""The rotation's work, frozen: the operations and bytes of one U' M GEMM.

The program rotates each SNP block into the kinship's eigenbasis, U' (r, n)
times the block (n, B): r = n for a dense kinship's whole basis, r = p_k
for a low-rank kinship's top space (``core/eigen.py::rotate``,
``api._rotate_top``).  Frozen with the benchmark, so that a change to the
program cannot move the yardstick.
"""

from __future__ import annotations

from typing import Tuple


def flops_and_bytes(r: int, n: int, B: int) -> Tuple[float, float]:
    """Work of one (r, n) x (n, B) float32 product: (floating-point
    operations, bytes).  A multiply-add per (row, sample, column); each
    operand read once and the product written once."""
    return 2.0 * r * n * B, 4.0 * (r * n + n * B + r * B)
