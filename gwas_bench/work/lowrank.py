"""A low-rank kinship's top basis, frozen: the operations and bytes of its
two products (``core/lowrank.py::_top_space``).

The kinship is the GRM of p_k SNP columns G (n, p_k), streamed to the card
as 2-bit codes.  Its top basis takes the Gram G'G (p_k, p_k), the Gram's
eigendecomposition (not counted here: no closed form), and U_top = G V
(n, p_k).  The count is the work the math needs, whatever implements it:
the Gram is symmetric, so only its upper triangle is computed and written;
the codes are read once, the eigenvectors read once, U_top written once.
A program that streams G twice, or forms the whole Gram, spends time that
the share of the roofline shows.  Frozen with the benchmark, so that a
change to the program cannot move the yardstick.
"""

from __future__ import annotations

from typing import Tuple


def gram(n: int, pk: int) -> Tuple[float, float]:
    """Work of the Gram G'G of n samples and p_k SNPs: (floating-point
    operations, bytes).  A multiply-add per sample and unordered SNP pair
    (the p_k (p_k + 1) / 2 entries of a symmetric product); the 2-bit codes
    read and those entries written in float32."""
    tri = pk * (pk + 1) / 2
    return 2.0 * n * tri, n * pk / 4 + 4.0 * tri


def top_basis(n: int, pk: int) -> Tuple[float, float]:
    """Work of U_top = G V, (n, p_k) x (p_k, p_k): (floating-point
    operations, bytes).  A multiply-add per (sample, SNP, direction); the
    float32 eigenvectors read and U_top written (G's codes are counted once,
    by ``gram``)."""
    return 2.0 * n * pk * pk, 4.0 * pk * pk + 4.0 * n * pk
