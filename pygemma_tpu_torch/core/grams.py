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

* :func:`grams_shared_lambda_packed` / :func:`grams_shared_multi_packed`
  -- one lambda (or one lambda grid) for every SNP in the block: plain
  GEMMs.
* :func:`grams_per_snp_lambda_packed` -- each SNP carries its own lambda
  (bisection / Newton refinement).  Builds (B, n) weight matrices; the
  hand-written kernel in :mod:`pygemma_tpu_torch.ops.gram_kernel` computes
  the same sums without them (:func:`grams_per_snp_lambda_fused_packed`).

The builders stop before assembly (:class:`PackedGrams`: the shared block
as its triu vector, the per-SNP column's cross and self terms, the sums);
the REML kernel (:mod:`pygemma_tpu_torch.ops.reml_kernel`) reads those in
place, and :func:`assemble` makes the Gram tensors the PyTorch algebra
reads.  :func:`_complement_correct` folds in a :class:`GramComplement`:
the implicit low-rank kinship's complement eigenspace, added after the
top-space sums.  :func:`grams_shared_lambda` and
:func:`grams_per_snp_lambda` do both, for the score test and K1's plain
version.

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


class PackedGrams(NamedTuple):
    """The Gram tensors of one build before assembly, one row per power k
    in ascending order (the builder's ``ks``).  Leading axes are the lanes
    and broadcast against each other: a shared-lambda build's ``S`` has no
    SNP axis.

    ``S`` (..., K, m): the shared columns' block as its triu vector
    (:func:`pair_products` order); ``vS`` (..., K, s): the per-SNP column
    against the shared ones; ``vv`` (..., K): the per-SNP column's self
    term; ``sums``: the eigenvalue-weight sums.
    """

    S: torch.Tensor
    vS: torch.Tensor
    vv: torch.Tensor
    sums: GramSums


def assemble(p: PackedGrams) -> Tuple[torch.Tensor, ...]:
    """The (..., s+1, s+1) Gram of each row of ``p``, per-SNP column last."""
    lanes, s = p.vS.shape[:-2], p.vS.shape[-1]
    return tuple(
        _assemble_nd(unpack_sym(p.S[..., i, :], s).expand(lanes + (s, s)),
                     p.vS[..., i, :], p.vv[..., i])
        for i in range(p.vv.shape[-1]))


def _grams(p: PackedGrams, ks, comp, lam, mode: str, want_logh: bool):
    """Assemble ``p`` and fold in the complement (``mode`` as in
    :func:`_complement_correct`)."""
    grams = assemble(p)
    if comp is not None:
        return _complement_correct(grams, p.sums, ks, comp, lam, mode,
                                   want_logh)
    return grams, p.sums


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
    (lam (B,), A (B,t,t), sums (B,)).
    """
    B, s = comp.R_vS.shape
    B_block = grams[0].shape[1 if mode == "multi" else 0]
    if B != B_block:
        # (1, s) residuals would broadcast over the block without a word
        raise ValueError(f"the complement holds residuals of {B} SNPs for "
                         f"a block of {B_block}")
    wc, logc = _complement_wc(lam, comp)
    R = _assemble(comp.R_S, comp.R_vS, comp.R_vv, B, s)  # (B, t, t)
    # unit axes that broadcast a lambda-shaped weight against a Gram and
    # against a sum
    g_axes, s_axes = {"scalar": (0, 0), "multi": (3, 1),
                      "per_snp": (2, 0)}[mode]

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


def grams_shared_lambda_packed(
    lam: torch.Tensor,  # scalar
    ev: torch.Tensor,  # (n,)
    shared: torch.Tensor,  # (n, s)
    pairs: torch.Tensor,  # (n, m) = pair_products(shared)
    v: torch.Tensor,  # (n, B) per-SNP columns
    v2: torch.Tensor,  # (n, B) = v * v
    ks: Sequence[int],
    want_logh: bool = False,
) -> PackedGrams:
    """Packed parts with one lambda for the whole SNP block: S (K, m),
    vS (B, K, s), vv (B, K), scalar sums.

    Cost: one (B,n)x(n,s) GEMM and one (B,n)x(n,) matvec per k; the shared
    s x s block is an O(n m) reduction shared by every SNP.
    """
    h = lam * ev + 1.0
    d = 1.0 / h
    S, vS, vv = [], [], []
    dk = d
    for k in range(1, max(ks) + 1):
        if k in ks:
            S.append(pdot(pairs.T, dk))  # (m,)
            vS.append(pdot(v.T, dk[:, None] * shared))  # (B, s)
            vv.append(pdot(v2.T, dk))  # (B,)
        dk = dk * d
    sums = GramSums(
        sum_d=torch.sum(d),
        sum_d2=torch.sum(d * d),
        sum_logh=torch.sum(torch.log(h)) if want_logh else d.new_zeros(()),
    )
    return PackedGrams(torch.stack(S), torch.stack(vS, dim=1),
                       torch.stack(vv, dim=1), sums)


def grams_shared_lambda(lam, ev, shared, pairs, v, v2, ks: Sequence[int],
                        want_logh: bool = False,
                        comp: Optional[GramComplement] = None,
                        ) -> Tuple[Tuple[torch.Tensor, ...], GramSums]:
    """Gram tensors with one lambda for the whole SNP block:
    :func:`grams_shared_lambda_packed`, assembled to (B, s+1, s+1)."""
    p = grams_shared_lambda_packed(lam, ev, shared, pairs, v, v2, ks,
                                   want_logh)
    return _grams(p, ks, comp, lam, "scalar", want_logh)


def grams_shared_multi_packed(
    lams: torch.Tensor,  # (G,) grid of lambdas shared across the SNP block
    ev: torch.Tensor,  # (n,)
    shared: torch.Tensor,  # (n, s)
    pairs: torch.Tensor,  # (n, m)
    v: torch.Tensor,  # (n, B)
    v2: torch.Tensor,  # (n, B)
    ks: Sequence[int],
    want_logh: bool = False,
) -> PackedGrams:
    """Packed parts for a whole lambda *grid* at once: S (G, 1, K, m),
    vS (G, B, K, s), vv (G, B, K), sums (G, 1).

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
    vS = pdot(v.T, C).reshape(B, G, Kn, s)
    vv = pdot(v2.T, D.reshape(G * Kn, n).T).reshape(B, G, Kn)
    sums = GramSums(
        sum_d=torch.sum(d, dim=1)[:, None],  # (G, 1) broadcasts over B
        sum_d2=torch.sum(d * d, dim=1)[:, None],
        sum_logh=torch.sum(torch.log(h), dim=1)[:, None]
        if want_logh
        else d.new_zeros((G, 1)),
    )
    return PackedGrams(S[:, None], vS.permute(1, 0, 2, 3),
                       vv.permute(1, 0, 2), sums)


def grams_per_snp_lambda_packed(
    lam: torch.Tensor,  # (B,)
    ev: torch.Tensor,  # (n,)
    shared: torch.Tensor,  # (n, s)
    pairs: torch.Tensor,  # (n, m)
    v: torch.Tensor,  # (n, B)
    v2: torch.Tensor,  # (n, B)
    ks: Sequence[int],
    want_logh: bool = False,
) -> PackedGrams:
    """Packed parts with an independent lambda per SNP: S (B, K, m),
    vS (B, K, s), vv (B, K), sums (B,).

    Cost per k: a (B,n)x(n,m) GEMM for the shared pairs, a (B,n) elementwise
    product plus a (B,n)x(n,s) GEMM for the per-SNP column terms.
    """
    B = v.shape[1]
    h = lam[:, None] * ev[None, :] + 1.0  # (B, n)
    d = 1.0 / h
    S, vS, vv = [], [], []
    dk = d
    for k in range(1, max(ks) + 1):
        if k in ks:
            S.append(pdot(dk, pairs))  # (B, m)
            zk = v * dk.T  # (n, B)
            vS.append(pdot(zk.T, shared))  # (B, s)
            vv.append(torch.sum(v2 * dk.T, dim=0))  # (B,)
        dk = dk * d
    sums = GramSums(
        sum_d=torch.sum(d, dim=1),
        sum_d2=torch.sum(d * d, dim=1),
        sum_logh=torch.sum(torch.log(h), dim=1)
        if want_logh
        else d.new_zeros((B,)),
    )
    return PackedGrams(torch.stack(S, dim=1), torch.stack(vS, dim=1),
                       torch.stack(vv, dim=1), sums)


def grams_per_snp_lambda(lam, ev, shared, pairs, v, v2, ks: Sequence[int],
                         want_logh: bool = False,
                         comp: Optional[GramComplement] = None,
                         ) -> Tuple[Tuple[torch.Tensor, ...], GramSums]:
    """Gram tensors with an independent lambda per SNP:
    :func:`grams_per_snp_lambda_packed`, assembled to (B, s+1, s+1).
    Builds (B, n) weight matrices; the hand-written kernel in
    :mod:`pygemma_tpu_torch.ops.gram_kernel` computes the same sums without
    them (:func:`grams_per_snp_lambda_fused_packed`)."""
    p = grams_per_snp_lambda_packed(lam, ev, shared, pairs, v, v2, ks,
                                    want_logh)
    return _grams(p, ks, comp, lam, "per_snp", want_logh)


def grams_per_snp_lambda_fused_packed(
    lam: torch.Tensor,  # (B,) or (B, R) -- R lambda slots per SNP
    ev: torch.Tensor,  # (n,)
    shared: torch.Tensor,  # (n, s)
    pairs: torch.Tensor,  # (n, m)
    v: torch.Tensor,  # (n, B) per-SNP columns (natural genotype layout)
    ks: Sequence[int],
    want_logh: bool = False,
) -> PackedGrams:
    """Kernel-fused variant of :func:`grams_per_snp_lambda_packed`: views of
    K1's output rows, S (B[, R], K, m), vS (B[, R], K, s), vv (B[, R], K),
    sums (B[, R]).

    Same numerical contract; on a CUDA tensor the (n, B) weight matrices
    never reach device memory (see pygemma_tpu_torch/ops/gram_kernel.py).
    With a 2-D ``lam`` all R slots share one pass over the genotype
    columns.
    """
    from ..ops.gram_kernel import fused_grams

    kmax = max(ks)
    S, vS, vv, sum_d, sum_d2, sum_logh = fused_grams(
        lam, ev, pairs, shared, v, kmax, want_logh
    )
    # ascending-k order, matching the non-fused builders (which iterate
    # range(1, kmax+1)) -- an unsorted caller ks never reorders the rows
    rows = tuple(k - 1 for k in sorted(ks))
    if rows != tuple(range(kmax)):
        idx = index_tensor(rows, str(S.device))
        S, vS, vv = (S.index_select(-2, idx), vS.index_select(-2, idx),
                     vv.index_select(-1, idx))
    return PackedGrams(S, vS, vv, GramSums(sum_d, sum_d2, sum_logh))


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
