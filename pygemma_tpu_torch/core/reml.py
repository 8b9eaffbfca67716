"""REML/ML likelihood machinery on Gram matrices, batched over SNPs.

In the kinship eigenbasis with H = lam*Lambda + I (diagonal), the projection

    P_V = H^-1 - H^-1 V (V' H^-1 V)^-1 V' H^-1

for a design V gives every GEMMA quantity.  With the Gram matrices
A_k = T' H^-k T from :mod:`pygemma_tpu_torch.core.grams` (T = [V | y],
design = first q columns, outcome = last), define

    G_k = A_k[:q, :q],  u_k = A_k[:q, -1],  s_k = A_k[-1, -1],  M = G_1^-1

then (Woodbury expansion of P_V):

    y'P y    = s_1 - u_1' M u_1
    y'P^2 y  = s_2 - 2 u_2' M u_1 + u_1' M G_2 M u_1
    y'P^3 y  = s_3 - 2 u_3' M u_1 + u_1' M G_3 M u_1 - w' M w,
               w = u_2 - G_2 M u_1
    tr(P)    = tr(H^-1) - tr(M G_2)
    tr(P^2)  = tr(H^-2) - 2 tr(M G_3) + tr(M G_2 M G_2)
    logdet(V'H^-1 V) = logdet(G_1)

The likelihood / derivative formulas replicate the reference "overload"
forms exactly, including their MIN_VAL clamps:
  * ell_R        : pygemma_model.pyx:1813-1830
  * d ell_R      : pygemma_model.pyx:1656-1669
  * d^2 ell_R    : pygemma_model.pyx:1675-1698
  * ML family    : pygemma_model.pyx:1542-1603
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import MIN_VAL
from .grams import GramSums


#: designs wider than this use torch's LAPACK/cuSOLVER-style kernels
_UNROLL_Q = 32


def small_cholesky(G: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky of tiny PD matrices, unrolled over the size q.

    Library batched Cholesky kernels are built for larger matrices; at
    (B, q, q) with q <= ~30 (q = covariates + 2) Cholesky-Crout unrolled in
    Python is q^2 elementwise (B,)-vector ops.
    """
    q = G.shape[-1]
    if q > _UNROLL_Q:
        return torch.linalg.cholesky(G)
    col = []  # columns of L, each (..., q)
    for j in range(q):
        s = G[..., j:, j]  # (..., q-j) column below/at diagonal
        for k in range(j):
            s = s - col[k][..., j:] * col[k][..., j:j + 1]
        # pivot clamp: a rank-deficient design yields huge-SE finite output
        # instead of NaN, matching the reference's MIN_VAL pivot guard
        # (pygemma_model.pyx:39, :993)
        pivot = torch.clamp_min(s[..., :1], MIN_VAL)
        diag = torch.sqrt(pivot)
        below = s[..., 1:] / diag
        cj = torch.cat(
            [G.new_zeros(G.shape[:-2] + (j,)), diag, below], dim=-1
        )
        col.append(cj)
    return torch.stack(col, dim=-1)  # (..., q, q) lower triangular


def chol_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched solve of (L L') x = rhs given lower-triangular L (..., q, q).

    Unrolled forward/back substitution for tiny q (see
    :func:`small_cholesky`); library triangular solves otherwise.
    """
    q = L.shape[-1]
    if q > _UNROLL_Q:
        z = torch.linalg.solve_triangular(L, rhs, upper=False)
        return torch.linalg.solve_triangular(L.transpose(-1, -2), z,
                                             upper=True)
    # forward: L z = rhs
    z = []
    for i in range(q):
        s = rhs[..., i, :]
        for j in range(i):
            s = s - L[..., i, j:j + 1] * z[j]
        z.append(s / L[..., i, i:i + 1])
    # backward: L' x = z
    x = [None] * q
    for i in reversed(range(q)):
        s = z[i]
        for j in range(i + 1, q):
            s = s - L[..., j, i:i + 1] * x[j]
        x[i] = s / L[..., i, i:i + 1]
    return torch.stack(x, dim=-2)  # (..., q, k)


def _trace(M: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


class RemlScalars(NamedTuple):
    """Per-SNP scalar bundle for one (lambda, design-width q) evaluation."""

    yPy: torch.Tensor
    yPPy: Optional[torch.Tensor]
    yPPPy: Optional[torch.Tensor]
    trP: Optional[torch.Tensor]
    trPP: Optional[torch.Tensor]
    logdet_G1: torch.Tensor


def reml_scalars(
    A1: torch.Tensor,
    A2: Optional[torch.Tensor],
    A3: Optional[torch.Tensor],
    sums: GramSums,
    q: int,
    *,
    need_third: bool = False,
) -> RemlScalars:
    """Extract the quadratic forms / traces for design = first ``q`` columns.

    A1/A2/A3: (..., t, t) Gram tensors (t > q); outcome column is last.
    ``need_third`` additionally produces y'P^3y and tr(P^2) (for the second
    derivative in Newton steps).
    """
    G1 = A1[..., :q, :q]
    u1 = A1[..., :q, -1]
    s1 = A1[..., -1, -1]
    L = small_cholesky(G1)
    Mu1 = chol_solve(L, u1[..., None])[..., 0]
    yPy = s1 - torch.sum(u1 * Mu1, dim=-1)
    logdet_G1 = 2.0 * torch.sum(
        torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1
    )

    yPPy = yPPPy = trP = trPP = None
    if A2 is not None:
        G2 = A2[..., :q, :q]
        u2 = A2[..., :q, -1]
        s2 = A2[..., -1, -1]
        G2Mu1 = torch.einsum("...ij,...j->...i", G2, Mu1)
        yPPy = (s2 - 2.0 * torch.sum(u2 * Mu1, dim=-1)
                + torch.sum(Mu1 * G2Mu1, dim=-1))
        MG2 = chol_solve(L, G2)
        trP = sums.sum_d - _trace(MG2)
        if need_third:
            if A3 is None:
                raise ValueError("need_third requires the k=3 Gram A3")
            G3 = A3[..., :q, :q]
            u3 = A3[..., :q, -1]
            s3 = A3[..., -1, -1]
            G3Mu1 = torch.einsum("...ij,...j->...i", G3, Mu1)
            w = u2 - G2Mu1
            Mw = chol_solve(L, w[..., None])[..., 0]
            yPPPy = (
                s3
                - 2.0 * torch.sum(u3 * Mu1, dim=-1)
                + torch.sum(Mu1 * G3Mu1, dim=-1)
                - torch.sum(w * Mw, dim=-1)
            )
            MG3 = chol_solve(L, G3)
            trPP = (
                sums.sum_d2
                - 2.0 * _trace(MG3)
                + torch.einsum("...ij,...ji->...", MG2, MG2)
            )
    return RemlScalars(yPy, yPPy, yPPPy, trP, trPP, logdet_G1)


def predictor_terms(A1: torch.Tensor, c: int):
    """Quadratic forms of the predictor of interest against the null design.

    With Gram order [W(0..c-1), x(c), y(c+1)] returns
    (x'P_c x, x'P_c y, y'P_c y) where P_c projects out W only -- the inputs
    of beta/se (reference calc_beta_vg_ve_restricted, pygemma_model.pyx:1501-1505)
    and of the score test.
    """
    Gw = A1[..., :c, :c]
    ux = A1[..., :c, c]
    uy = A1[..., :c, c + 1]
    L = small_cholesky(Gw)
    Mux = chol_solve(L, ux[..., None])[..., 0]
    Muy = chol_solve(L, uy[..., None])[..., 0]
    xPx = A1[..., c, c] - torch.sum(ux * Mux, dim=-1)
    xPy = A1[..., c, c + 1] - torch.sum(ux * Muy, dim=-1)
    yPy = A1[..., c + 1, c + 1] - torch.sum(uy * Muy, dim=-1)
    return xPx, xPy, yPy


def wald(A1: torch.Tensor, sums: GramSums, lam, n: int, c: int):
    """Wald statistics at lambda* from the [W, x, y] Gram of k = 1
    (reference calc_beta_vg_ve_restricted_overload, pyx:1514-1537): a
    (5, ...) stack of beta, se, tau, lambda and F, and the mask of
    predictors not collinear with W."""
    xPx, xPy, _ = predictor_terms(A1, c)
    alt = reml_scalars(A1, None, None, sums, c + 1)
    yPxy = torch.clamp_min(alt.yPy, MIN_VAL)
    df = float(n - c - 1)
    # Degenerate predictors (x collinear with W, e.g. a constant SNP) have
    # x'P_c x == 0 up to roundoff -- possibly exactly zero or negative on
    # the implicit path, where beta = xPy/xPx would emit inf and p = 0.
    # The reference's contract for a singular design is a FULL NaN row
    # (every column, lmm/lmm.py:484-493): gate every per-SNP output on the
    # same mask.
    x_ok = xPx > MIN_VAL
    nan = float("nan")
    beta = torch.where(x_ok, xPy / torch.clamp_min(xPx, MIN_VAL), nan)
    se_beta = torch.where(
        x_ok,
        torch.sqrt(yPxy) / (torch.sqrt(torch.clamp_min(xPx, MIN_VAL))
                            * math.sqrt(df)),
        nan,
    )
    tau = torch.where(x_ok, df / yPxy, nan)
    lam = torch.where(x_ok, lam, nan)
    F_wald = torch.square(beta / se_beta)
    return torch.stack([beta, se_beta, tau, lam, F_wald]), x_ok


# ---------------------------------------------------------------------------
# Restricted (REML) likelihood family -- "overload" forms.
# q below is the number of columns of the design the projection removes
# (the reference passes its full [W|x] width; pygemma_model.pyx:1631-1649).
# ---------------------------------------------------------------------------


def restricted_const(n, q) -> float:
    """The lambda-free constant of ell_R (pygemma_model.pyx:1813-1830)."""
    nf = float(n - q)
    return 0.5 * nf * math.log(0.5 * nf / math.pi) - 0.5 * nf


def ml_const(n) -> float:
    """The lambda-free constant of the ML ell (pygemma_model.pyx:1542-1560)."""
    nf = float(n)
    return 0.5 * nf * math.log(nf / (2.0 * math.pi)) - 0.5 * nf


def loglik_restricted(lam, n, q, yPy, sum_logh, logdet_G1):
    """ell_R(lambda); reference pygemma_model.pyx:1813-1830.

    The lambda-independent logdet(V'V) term is omitted exactly as the
    reference's precompute path does; only differences in lambda matter.
    The log argument is clamped to MIN_VAL so a degenerate SNP yields a huge
    negative likelihood instead of NaN-poisoning the argmax.
    """
    nf = float(n - q)
    return (
        restricted_const(n, q)
        - 0.5 * sum_logh
        - 0.5 * logdet_G1
        - 0.5 * nf * torch.log(torch.clamp_min(yPy, MIN_VAL))
    )


def d1_restricted(lam, n, q, yPy, yPPy, trP):
    """d ell_R / d lambda; reference pygemma_model.pyx:1656-1669.

    The asymmetric ``max(yPPy, 0)`` (not MIN_VAL) is the reference's."""
    yPy_c = torch.clamp_min(yPy, MIN_VAL)
    nf = float(n - q)
    return (
        -0.5 * (n - q - trP) / lam
        + 0.5 * nf * ((yPy_c - torch.clamp_min(yPPy, 0.0)) / lam) / yPy_c
    )


def d2_restricted(lam, n, q, yPy, yPPy, yPPPy, trP, trPP):
    """d^2 ell_R / d lambda^2; reference pygemma_model.pyx:1675-1698."""
    yPy_c = torch.clamp_min(yPy, MIN_VAL)
    yPPy_c = torch.clamp_min(yPPy, MIN_VAL)
    yPPPy_c = torch.clamp_min(yPPPy, MIN_VAL)
    lam2 = lam * lam
    yPGPGPy = (yPy_c + yPPPy_c - 2.0 * yPPy_c) / lam2
    yPGPy = (yPy_c - yPPy_c) / lam
    nf = float(n - q)
    result = 0.5 * (n - q + trPP - 2.0 * trP) / lam2
    return result - nf * (yPGPGPy * yPy_c - 0.5 * yPGPy * yPGPy) / (yPy_c * yPy_c)


# ---------------------------------------------------------------------------
# Maximum-likelihood family (for the LRT; reference pygemma_model.pyx:1542-1603)
# ---------------------------------------------------------------------------


def loglik_ml(lam, n, yPy, sum_logh):
    """ell(lambda), profiled ML log-likelihood; pygemma_model.pyx:1542-1560."""
    nf = float(n)
    return (ml_const(n) - 0.5 * sum_logh
            - 0.5 * nf * torch.log(torch.clamp_min(yPy, MIN_VAL)))


def d1_ml(lam, n, yPy, yPPy, sum_d):
    """d ell / d lambda; pygemma_model.pyx:1566-1581."""
    num = torch.clamp_min(yPPy, MIN_VAL)
    denom = torch.clamp_min(yPy, MIN_VAL)
    return -0.5 * (n - sum_d) / lam + 0.5 * n * (1.0 - num / denom) / lam


def d2_ml(lam, n, yPy, yPPy, yPPPy, sum_d, sum_d2):
    """d^2 ell / d lambda^2; pygemma_model.pyx:1586-1603."""
    yPy_c = torch.clamp_min(yPy, MIN_VAL)
    yPPy_c = torch.clamp_min(yPPy, MIN_VAL)
    yPPPy_c = torch.clamp_min(yPPPy, MIN_VAL)
    lam2 = lam * lam
    yPGPGPy = (yPy_c + yPPPy_c - 2.0 * yPPy_c) / lam2
    yPGPy = (yPy_c - yPPy_c) / lam
    result = 0.5 * (n + sum_d2 - 2.0 * sum_d) / lam2
    return result - 0.5 * n * (2.0 * yPGPGPy - yPGPy * yPGPy / yPy_c) / yPy_c
