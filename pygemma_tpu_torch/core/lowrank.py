"""Exact low-rank kinship eigendecomposition, on the device.

A GRM built from p_k SNPs is exactly low-rank plus a ridge:

    K = s * G G' + eps * I,      G (n, p_k) standardized genotypes, p_k < n

Its full eigendecomposition never needs an O(n^3) dense eigh: with
A = s * G'G = V diag(a) V' (p_k x p_k),

    top eigenpairs:        ev_i = a_i + eps,  u_i = G v_i * sqrt(s / a_i)
    complement (n - p_k):  ev = eps, any orthonormal basis of null(G')

so the whole basis comes from one p_k x p_k eigh plus two GEMMs and, when
an explicit basis is wanted, a QR-completed complement.  The scan does not
want one: :func:`lowrank_top_basis` returns the top space only, and the
complement enters the Grams symbolically (core/grams.py::GramComplement).

Exact to float32 roundoff; tests/test_torch_lowrank.py holds the basis
against a dense float64 eigh and the scan against the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..io.streaming import SnpBlockStreamer
from ..utils import profiling
from .eigen import auto_eigendecompose

#: SNP columns per block when G streams to the device for its Gram
GRAM_BLOCK = 8192


class ImplicitBasis(NamedTuple):
    """Top eigenspace of a low-rank kinship, without the n x n basis.

    Every complement direction of K = s*GG' + eps*I shares the single
    eigenvalue eps, so the scan builds its Grams from ``C = U_top' T`` plus
    lambda-independent residuals: the basis takes n*p_k values instead of
    n^2, and the per-block rotation GEMM costs n*p_k*B instead of n^2*B.

    ``ev_top``: (p_k,) kinship eigenvalues of the top space (a_i + eps,
    ascending; rank-deficient Gram directions hold exactly eps).
    ``U_top``: (n, p_k) orthonormal columns (zero on rank-deficient dirs).
    """

    ev_top: torch.Tensor
    U_top: torch.Tensor
    eps: float
    n: int


class LowRankKinship:
    """Symbolic kinship ``K = scale * G G' + eps * I`` (never materialized).

    ``G``: (n, p_k) array-like of standardized/centered SNP columns --
    ndarray, memmap, QuantizedMatrix or PackedMatrix (column blocks stream
    to the device once).
    ``scale``: defaults to 1/p_k (the GRM convention K = GG'/p).
    ``eps``: ridge added to the diagonal.
    ``center``: re-center the columns on the device before the Gram.
    """

    def __init__(self, G, scale: Optional[float] = None, eps: float = 0.0,
                 center: bool = True):
        self.G = G
        n, pk = G.shape
        if pk >= n:
            raise ValueError(
                f"low-rank path needs p_k < n (got G {G.shape}); "
                "use a dense kinship instead")
        self.n = int(n)
        self.pk = int(pk)
        self.scale = float(scale) if scale is not None else 1.0 / pk
        self.eps = float(eps)
        self.center = bool(center)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    def dense(self) -> np.ndarray:
        """Materialize K on the host (tests / small problems only)."""
        Gf = np.asarray(self.G[:, :], np.float64)
        if self.center:
            Gf = Gf - Gf.mean(0, keepdims=True)
        K = self.scale * (Gf @ Gf.T)
        K[np.diag_indices(self.n)] += self.eps
        return K.astype(np.float32)

    def fingerprint_bytes(self) -> bytes:
        """Strided content sample for the driver's eigen-checkpoint key;
        the same bytes as ``pygemma_tpu.core.lowrank.LowRankKinship``'s."""
        # quantized/packed sources: hash raw codes; ndarrays: hash values
        src = self.G.data if hasattr(self.G, "quant_block") else self.G
        arr = np.asarray(src[:: max(1, src.shape[0] // 64),
                             :: max(1, src.shape[1] // 64)])
        return (repr((self.n, self.pk, self.scale, self.eps,
                      self.center)).encode() + arr.tobytes())


def _gram_scaled(G: torch.Tensor, scale: float, center: bool):
    """A = scale * Gc'Gc with on-device column re-centering (Gc = G - 1 mu');
    returns (A, Gc)."""
    if center:
        G = G - torch.mean(G, dim=0, keepdim=True)
    return scale * torch.matmul(G.T, G), G


def _top_basis(Gc: torch.Tensor, V: torch.Tensor, a: torch.Tensor,
               scale: float, rank_tol: float):
    """U_top = Gc V * sqrt(scale / a) with tiny-a columns zeroed."""
    GV = torch.matmul(Gc, V)
    a_ok = a > rank_tol
    inv = torch.where(a_ok, torch.sqrt(scale / torch.clamp_min(a, rank_tol)),
                      0.0)
    return GV * inv[None, :], a_ok


def _complement_qr(U_top: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the orthogonal complement of span(U_top):
    project a random block out of the span twice (the second pass keeps
    float32 drift ~1e-6), then QR."""
    R = Z - torch.matmul(U_top, torch.matmul(U_top.T, Z))
    Q, _ = torch.linalg.qr(R)
    Q = Q - torch.matmul(U_top, torch.matmul(U_top.T, Q))
    Q, _ = torch.linalg.qr(Q)
    return Q


def _stream_gram(lrk: LowRankKinship, block: int, device: torch.device):
    """Stream G's columns to the device once and build the scaled p_k x p_k
    Gram (packed/quantized sources ship codes and dequantize there)."""
    pk = lrk.pk
    cols = [xb[:, : min(stop, pk) - start]
            for start, stop, xb in SnpBlockStreamer(
                lrk.G, min(block, pk), dtype=np.float32, device=device)]
    G = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
    del cols
    return _gram_scaled(G.to(torch.float32), lrk.scale, lrk.center)


def _top_space(lrk: LowRankKinship, backend: str, block: int,
               rank_rtol: float, device: torch.device,
               respool_bytes: int = 1 << 31):
    """(ev_top, U_top, a, a_ok, n_null): the exact top eigenspace of K.

    ev_top holds a_i + eps for kept Gram directions and exactly eps for
    rank-deficient ones (whose U_top column is zeroed), so the weight sums
    over the p_k entries are exact with fixed shapes.

    Its stages are the spans ``lowrank.stream_gram``, ``lowrank.gram_eigh``
    and ``lowrank.top_basis`` (utils/profiling.py).
    """
    with profiling.span("lowrank.stream_gram", device):
        A, Gc = _stream_gram(lrk, block, device)
        # at large n the (n, p_k) float32 G and the Gram eigh's workspace
        # need not sit on the device together: drop G and re-stream it
        # after the eigh (the rebuild is deterministic)
        respool = lrk.n * lrk.pk * 4 > respool_bytes
        if respool:
            del Gc
    with profiling.span("lowrank.gram_eigh", device):
        a, V = auto_eigendecompose(A, backend=backend, dtype=np.float32,
                                   device=device)
        a = torch.clamp_min(a, 0.0)
        del A
    with profiling.span("lowrank.top_basis", device):
        if respool:
            _, Gc = _stream_gram(lrk, block, device)
        rank_tol = float(rank_rtol) * float(torch.max(a))
        U_top, a_ok = _top_basis(Gc, V, a, lrk.scale, rank_tol)
        n_null = int(torch.sum(~a_ok))
        ev_top = torch.where(a_ok, a, 0.0) + lrk.eps
    return ev_top, U_top, a, a_ok, n_null


def lowrank_top_basis(
    lrk: LowRankKinship,
    backend: str = "auto",
    block: int = GRAM_BLOCK,
    rank_rtol: float = 1e-6,
    respool_bytes: int = 1 << 31,
    device="cuda",
) -> ImplicitBasis:
    """Implicit eigendecomposition: the top space only, no complement basis.

    The whole cost is one p_k x p_k Gram eigh plus two device GEMMs; the
    (n - p_k)-dimensional eps-eigenspace is represented symbolically (see
    :class:`ImplicitBasis`), so no n x n object ever exists.
    """
    dev = resolve_device(device)
    ev_top, U_top, _, _, _ = _top_space(lrk, backend, block, rank_rtol, dev,
                                        respool_bytes)
    return ImplicitBasis(torch.clamp_min(ev_top, 0.0), U_top,
                         float(lrk.eps), lrk.n)


def lowrank_eigendecompose(
    lrk: LowRankKinship,
    backend: str = "auto",
    dtype=np.float32,
    block: int = GRAM_BLOCK,
    seed: int = 0,
    rank_rtol: float = 1e-6,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full (ev, U) of K = scale * G G' + eps * I without forming K.

    Returns eigenvalues ascending with the >= 0 clamp and the complete
    n x n eigenbasis, both on ``device``.  Prefer :func:`lowrank_top_basis`
    for scans: the complement QR here costs O(n^2 (n - p_k)) and an n x n
    basis; it exists for parity checks and for callers that need the full
    U.  The complement is drawn from ``torch.Generator(device)`` seeded with
    ``seed``, so its basis differs from the JAX package's; the statistics do
    not.
    """
    dev = resolve_device(device)
    n, pk = lrk.n, lrk.pk
    _, U_top, a, a_ok, n_null = _top_space(lrk, backend, block, rank_rtol,
                                           dev)
    # complement basis: n - pk dims (+ any rank-deficient Gram dims)
    n_comp = n - pk + n_null
    gen = torch.Generator(device=dev).manual_seed(seed)
    Z = torch.randn((n, n_comp), generator=gen, device=dev,
                    dtype=torch.float32)
    # zeroed rank-deficient columns of U_top are harmless in the projector
    Q_c = _complement_qr(U_top, Z)
    # assemble ascending: [eps * (n_comp), a_kept + eps]
    if n_null:
        keep = torch.nonzero(a_ok).reshape(-1)
        a = a[keep]
        U_top = U_top[:, keep]
    ev = torch.cat([torch.full((n_comp,), lrk.eps, dtype=torch.float32,
                               device=dev), a + lrk.eps])
    U = torch.cat([Q_c, U_top], dim=1)
    return (torch.clamp_min(ev, 0.0).to(torch_dtype(dtype)),
            U.to(torch_dtype(dtype)))
