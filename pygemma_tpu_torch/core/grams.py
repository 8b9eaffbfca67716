"""Batched Gram-matrix construction for the GEMMA rotated-space REML problem.

In the eigenbasis of the kinship matrix, every quantity the REML/ML lambda
optimization and the Wald/LRT/score statistics need is a function of the
small Gram matrices

    A_k = T' diag(1 / (lam * Lambda + 1)^k) T,      k = 1, 2, 3

where ``T = [shared columns | per-SNP column]`` stacks the rotated covariates,
phenotype and one genotype column.  Building ``A_k`` for a whole block of B
SNPs at once is a handful of large matmuls, after which all likelihood
evaluations are O(B * t^3) batched small-matrix algebra
(:mod:`pygemma_tpu_torch.core.reml`).

* :func:`grams_shared_lambda` / :func:`grams_shared_multi` -- one lambda (or
  one lambda grid) for every SNP in the block: plain GEMMs.
* :func:`grams_per_snp_lambda` -- each SNP carries its own lambda
  (bisection / Newton refinement).  Builds (B, n) weight matrices; the
  hand-written kernel in :mod:`pygemma_tpu_torch.ops.gram_kernel` computes
  the same sums without them (:func:`grams_per_snp_lambda_fused`).

Each builder takes an optional :class:`GramComplement`: the implicit
low-rank kinship's complement eigenspace, folded in after the top-space
sums.

Every matmul here runs in full float32 or float64: the entry points refuse
to run with TF32 enabled (device.py::check_matmul_precision).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision matmul (TF32 stays off; see the module docstring)."""
    return torch.matmul(a, b)


class GramSums(NamedTuple):
    """Per-SNP (or scalar, when lambda is shared) eigenvalue-weight sums.

    ``sum_d``   = sum_i 1/(lam*Lambda_i + 1)        -> tr(H^-1)
    ``sum_d2``  = sum_i 1/(lam*Lambda_i + 1)^2      -> tr(H^-2)
    ``sum_logh``= sum_i log(lam*Lambda_i + 1)       -> logdet(H)
    """

    sum_d: torch.Tensor
    sum_d2: torch.Tensor
    sum_logh: torch.Tensor


class GramComplement(NamedTuple):
    """Implicit-complement extension of a Gram problem (low-rank kinship).

    For K = s*GG' + eps*I the (n - p_k)-dimensional complement eigenspace
    has the single eigenvalue eps, so the scan never needs the n x n
    eigenbasis: columns are rotated only into the p_k-dimensional top space
    (c = U_top' t), and the lambda-independent residual Grams

        R = T'T - C'C          (split as R_S / R_vS / R_vv below)

    are carried once per block.  Every weighted Gram then corrects in
    O(s^2) per SNP:

        A_k = [c-space Gram with weights (lam*ev_top + 1)^-k]
              + w_c^k * R,              w_c = 1/(lam*eps + 1)
        sum_{d^k} += n_comp * w_c^k;    sum_logh += n_comp*log(lam*eps + 1)

    ``n_comp`` = n - p_k.  Rank-deficient Gram directions keep a zero U_top
    column with ev_top = eps, so shapes stay fixed and the residual picks
    their mass up at exactly the complement weight.
    """

    eps: torch.Tensor  # () ridge = the complement eigenvalue
    n_comp: int  # n - p_k
    R_S: torch.Tensor  # (s, s) residual Gram of the shared columns
    R_vS: torch.Tensor  # (B, s) residual cross terms of the per-SNP column
    R_vv: torch.Tensor  # (B,)   residual self terms


def _complement_wc(lam, comp: GramComplement):
    """w_c = 1/(lam*eps + 1) and log(lam*eps + 1), shaped like ``lam``."""
    he = lam * comp.eps + 1.0
    return 1.0 / he, torch.log(he)


@functools.lru_cache(maxsize=64)
def index_tensor(values: Tuple[int, ...], device: str) -> torch.Tensor:
    """Cached int64 index tensor on ``device``.

    Built once per (values, device): a fresh host->device index copy inside
    the block loop would wait for the card at every call."""
    return torch.tensor(values, dtype=torch.long, device=device)


def pair_index(s: int) -> Tuple[np.ndarray, np.ndarray]:
    """Upper-triangle (i<=j) index pair arrays for s shared columns."""
    return np.triu_indices(s)


def pair_products(shared: torch.Tensor) -> torch.Tensor:
    """Elementwise pair products of the shared columns.

    shared: (n, s)  ->  (n, m) with m = s*(s+1)/2, column order = triu (i<=j).
    """
    iu, ju = pair_index(shared.shape[1])
    dev = str(shared.device)
    return (shared.index_select(1, index_tensor(tuple(iu.tolist()), dev))
            * shared.index_select(1, index_tensor(tuple(ju.tolist()), dev)))


def _sym_gather(s: int) -> Tuple[int, ...]:
    """For each (i, j) of an s x s matrix, its position in the triu vector."""
    iu, ju = pair_index(s)
    pos = np.zeros((s, s), np.int64)
    pos[iu, ju] = np.arange(iu.size)
    pos[ju, iu] = np.arange(iu.size)
    return tuple(pos.reshape(-1).tolist())


def unpack_sym(vec: torch.Tensor, s: int) -> torch.Tensor:
    """Inverse of :func:`pair_products` reduction: (..., m) -> (..., s, s)."""
    idx = index_tensor(_sym_gather(s), str(vec.device))
    return vec.index_select(-1, idx).reshape(vec.shape[:-1] + (s, s))


def _assemble_nd(S_k, vS_k, vv_k):
    """(..., s, s) + (..., s) + (...,) -> (..., s+1, s+1), per-SNP col last."""
    top = torch.cat([S_k, vS_k.unsqueeze(-1)], dim=-1)  # (..., s, s+1)
    bottom = torch.cat([vS_k, vv_k.unsqueeze(-1)], dim=-1)  # (..., s+1)
    return torch.cat([top, bottom.unsqueeze(-2)], dim=-2)


def _assemble(S_k, vS_k, vv_k, B: int, s: int) -> torch.Tensor:
    """Assemble the (B, s+1, s+1) Gram with the per-SNP column last."""
    if S_k.ndim == 2:
        S_k = S_k.expand(B, s, s)
    return _assemble_nd(S_k, vS_k, vv_k)


def _complement_correct(grams, sums: GramSums, ks, comp: GramComplement,
                        lam, mode: str, want_logh: bool):
    """Fold the implicit complement into c-space Grams/sums (O(s^2)/SNP).

    ``mode`` names the lambda layout: "scalar" (lam (), A (B,t,t), sums
    scalar), "multi" (lam (G,), A (G,B,t,t), sums (G,1)), "per_snp"
    (lam (B,), A (B,t,t), sums (B,)), "slots" (lam (B,R), A (B,R,t,t),
    sums (B,R)).
    """
    B, s = comp.R_vS.shape
    B_block = grams[0].shape[1 if mode == "multi" else 0]
    if B != B_block:
        # (1, s) residuals would broadcast over the block without a word
        raise ValueError(f"the complement holds residuals of {B} SNPs for "
                         f"a block of {B_block}")
    wc, logc = _complement_wc(lam, comp)
    R = _assemble(comp.R_S, comp.R_vS, comp.R_vv, B, s)  # (B, t, t)
    if mode == "slots":
        R = R[:, None]
    # unit axes that broadcast a lambda-shaped weight against a Gram and
    # against a sum
    g_axes, s_axes = {"scalar": (0, 0), "multi": (3, 1), "per_snp": (2, 0),
                      "slots": (2, 0)}[mode]

    def unit(w, k):
        return w.reshape(w.shape + (1,) * k)

    nc = float(comp.n_comp)
    # every builder returns grams in ascending-k order, so sorted(ks) is
    # the zip order however the caller spelled ks
    grams = tuple(A + unit(wc ** k, g_axes) * R
                  for A, k in zip(grams, sorted(ks)))
    sums = GramSums(
        sum_d=sums.sum_d + nc * unit(wc, s_axes),
        sum_d2=sums.sum_d2 + nc * unit(wc * wc, s_axes),
        sum_logh=(sums.sum_logh + nc * unit(logc, s_axes) if want_logh
                  else sums.sum_logh),
    )
    return grams, sums


def grams_shared_lambda(
    lam: torch.Tensor,  # scalar
    ev: torch.Tensor,  # (n,)
    shared: torch.Tensor,  # (n, s)
    pairs: torch.Tensor,  # (n, m) = pair_products(shared)
    v: torch.Tensor,  # (n, B) per-SNP columns
    v2: torch.Tensor,  # (n, B) = v * v
    ks: Sequence[int],
    want_logh: bool = False,
    comp: Optional[GramComplement] = None,
) -> Tuple[Tuple[torch.Tensor, ...], GramSums]:
    """Gram tensors with one lambda for the whole SNP block.

    Cost: one (B,n)x(n,s) GEMM and one (B,n)x(n,) matvec per k; the shared
    s x s block is an O(n m) reduction shared by every SNP.
    """
    n, s = shared.shape
    B = v.shape[1]
    h = lam * ev + 1.0
    d = 1.0 / h
    grams = []
    dk = d
    for k in range(1, max(ks) + 1):
        if k in ks:
            S_k = unpack_sym(pdot(pairs.T, dk), s)  # (s, s)
            vS_k = pdot(v.T, dk[:, None] * shared)  # (B, s)
            vv_k = pdot(v2.T, dk)  # (B,)
            grams.append(_assemble(S_k, vS_k, vv_k, B, s))
        dk = dk * d
    sums = GramSums(
        sum_d=torch.sum(d),
        sum_d2=torch.sum(d * d),
        sum_logh=torch.sum(torch.log(h)) if want_logh else d.new_zeros(()),
    )
    if comp is not None:
        return _complement_correct(tuple(grams), sums, ks, comp, lam,
                                   "scalar", want_logh)
    return tuple(grams), sums


def grams_shared_multi(
    lams: torch.Tensor,  # (G,) grid of lambdas shared across the SNP block
    ev: torch.Tensor,  # (n,)
    shared: torch.Tensor,  # (n, s)
    pairs: torch.Tensor,  # (n, m)
    v: torch.Tensor,  # (n, B)
    v2: torch.Tensor,  # (n, B)
    ks: Sequence[int],
    want_logh: bool = False,
    comp: Optional[GramComplement] = None,
) -> Tuple[Tuple[torch.Tensor, ...], GramSums]:
    """Gram tensors for a whole lambda *grid* at once: (G, B, s+1, s+1).

    Batching every (lambda, k) weight column into one wide GEMM reads the
    genotype block exactly once.
    """
    n, s = shared.shape
    B = v.shape[1]
    G = lams.shape[0]
    Kn = len(ks)
    h = lams[:, None] * ev[None, :] + 1.0  # (G, n)
    d = 1.0 / h
    dks = []
    dk = d
    for k in range(1, max(ks) + 1):
        if k in ks:
            dks.append(dk)
        dk = dk * d
    D = torch.stack(dks, dim=1)  # (G, K, n)

    S = torch.einsum("gkn,nm->gkm", D, pairs)  # (G, K, m)
    # (n, G*K*s) weighted copies of the shared columns -> single GEMM with v
    C = (D[:, :, :, None] * shared[None, None, :, :]).permute(2, 0, 1, 3)
    C = C.reshape(n, G * Kn * s)
    vS = pdot(v.T, C).reshape(B, G, Kn, s)  # (B, G, K, s)
    vv = pdot(v2.T, D.reshape(G * Kn, n).T).reshape(B, G, Kn)

    grams = []
    for ki in range(Kn):
        S_k = unpack_sym(S[:, ki], s)  # (G, s, s)
        grams.append(_assemble_nd(
            S_k[:, None].expand(G, B, s, s),
            vS[:, :, ki].permute(1, 0, 2),
            vv[:, :, ki].T,
        ))
    sums = GramSums(
        sum_d=torch.sum(d, dim=1)[:, None],  # (G, 1) broadcasts over B
        sum_d2=torch.sum(d * d, dim=1)[:, None],
        sum_logh=torch.sum(torch.log(h), dim=1)[:, None]
        if want_logh
        else d.new_zeros((G, 1)),
    )
    if comp is not None:
        return _complement_correct(tuple(grams), sums, ks, comp, lams,
                                   "multi", want_logh)
    return tuple(grams), sums


def grams_per_snp_lambda(
    lam: torch.Tensor,  # (B,)
    ev: torch.Tensor,  # (n,)
    shared: torch.Tensor,  # (n, s)
    pairs: torch.Tensor,  # (n, m)
    v: torch.Tensor,  # (n, B)
    v2: torch.Tensor,  # (n, B)
    ks: Sequence[int],
    want_logh: bool = False,
    comp: Optional[GramComplement] = None,
) -> Tuple[Tuple[torch.Tensor, ...], GramSums]:
    """Gram tensors with an independent lambda per SNP.

    Cost per k: a (B,n)x(n,m) GEMM for the shared pairs, a (B,n) elementwise
    product plus a (B,n)x(n,s) GEMM for the per-SNP column terms.
    """
    n, s = shared.shape
    B = v.shape[1]
    h = lam[:, None] * ev[None, :] + 1.0  # (B, n)
    d = 1.0 / h
    grams = []
    dk = d
    for k in range(1, max(ks) + 1):
        if k in ks:
            S_k = unpack_sym(pdot(dk, pairs), s)  # (B, s, s)
            zk = v * dk.T  # (n, B)
            vS_k = pdot(zk.T, shared)  # (B, s)
            vv_k = torch.sum(v2 * dk.T, dim=0)  # (B,)
            grams.append(_assemble(S_k, vS_k, vv_k, B, s))
        dk = dk * d
    sums = GramSums(
        sum_d=torch.sum(d, dim=1),
        sum_d2=torch.sum(d * d, dim=1),
        sum_logh=torch.sum(torch.log(h), dim=1)
        if want_logh
        else d.new_zeros((B,)),
    )
    if comp is not None:
        return _complement_correct(tuple(grams), sums, ks, comp, lam,
                                   "per_snp", want_logh)
    return tuple(grams), sums


def grams_per_snp_lambda_fused(
    lam: torch.Tensor,  # (B,) or (B, R) -- R lambda slots per SNP
    ev: torch.Tensor,  # (n,)
    shared: torch.Tensor,  # (n, s)
    pairs: torch.Tensor,  # (n, m)
    v: torch.Tensor,  # (n, B) per-SNP columns (natural genotype layout)
    ks: Sequence[int],
    want_logh: bool = False,
    comp: Optional[GramComplement] = None,
) -> Tuple[Tuple[torch.Tensor, ...], GramSums]:
    """Kernel-fused variant of :func:`grams_per_snp_lambda`.

    Same numerical contract; on a CUDA tensor the (n, B) weight matrices
    never reach device memory (see pygemma_tpu_torch/ops/gram_kernel.py).
    With a 2-D ``lam`` all R slots share one pass over the genotype
    columns; Gram tensors come back with a slot axis: (B, R, s+1, s+1).
    """
    from ..ops.gram_kernel import fused_grams

    s = shared.shape[1]
    kmax = max(ks)
    S, vS, vv, sum_d, sum_d2, sum_logh = fused_grams(
        lam, ev, pairs, shared, v, kmax, want_logh
    )
    # ascending-k order, matching the non-fused builders (which iterate
    # range(1, kmax+1)) -- an unsorted caller ks never reorders the tuple
    grams = []
    for k in sorted(ks):
        S_k = unpack_sym(S[..., k - 1, :], s)
        grams.append(_assemble_nd(S_k, vS[..., k - 1, :], vv[..., k - 1]))
    sums = GramSums(sum_d=sum_d, sum_d2=sum_d2, sum_logh=sum_logh)
    if comp is not None:
        # the complement correction stays outside the kernel: O(s^2) work
        # per (SNP, slot) on the kernel's outputs
        return _complement_correct(
            tuple(grams), sums, ks, comp, lam,
            "per_snp" if lam.ndim == 1 else "slots", want_logh)
    return tuple(grams), sums


def grams_per_snp_lambda_slots(
    lam: torch.Tensor,  # (B, R)
    ev: torch.Tensor,
    shared: torch.Tensor,
    pairs: torch.Tensor,
    v: torch.Tensor,
    v2: torch.Tensor,
    ks: Sequence[int],
    want_logh: bool = False,
    comp: Optional[GramComplement] = None,
) -> Tuple[Tuple[torch.Tensor, ...], GramSums]:
    """Unfused multi-slot lambda: per-slot builds stacked on axis 1."""
    parts = [
        grams_per_snp_lambda(lam[:, r], ev, shared, pairs, v, v2, ks,
                             want_logh=want_logh, comp=comp)
        for r in range(lam.shape[1])
    ]
    grams = tuple(
        torch.stack([p[0][i] for p in parts], dim=1)
        for i in range(len(parts[0][0]))
    )
    sums = GramSums(
        sum_d=torch.stack([p[1].sum_d for p in parts], dim=1),
        sum_d2=torch.stack([p[1].sum_d2 for p in parts], dim=1),
        sum_logh=torch.stack([p[1].sum_logh for p in parts], dim=1),
    )
    return grams, sums


def permute_x_before_y(A: torch.Tensor, c: int) -> torch.Tensor:
    """Reorder a Gram built with shared=[W, y], per-SNP=x into [W, x, y] order.

    After this, the alternative design [W, x] occupies the first c+1 indices
    and the outcome y is last -- the layout :mod:`pygemma_tpu_torch.core.reml`
    expects.  DE mode skips this permutation: there the design is [W, y] and
    the outcome is the genotype column.
    """
    t = A.shape[-1]  # == c + 2
    perm = index_tensor(tuple(range(c)) + (t - 1, c), str(A.device))
    return A.index_select(-2, perm).index_select(-1, perm)
