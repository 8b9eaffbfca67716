"""Per-block association testing: Wald / LRT / score, batched over SNPs.

The replacement for the reference's per-SNP worker loop (``calculate`` /
``calculate_de``, reference lmm/lmm.py:461-532): one function maps a block of
rotated genotype columns to per-SNP statistics.  Per-SNP failure containment
(the reference catches LinAlgError and emits a NaN row, lmm/lmm.py:484-493)
falls out of the batched algebra plus the explicit NaN-row masks below.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from scipy import stats

from ..config import GwasConfig, MIN_VAL
from . import reml
from .grams import (
    GramComplement,
    grams_per_snp_lambda_fused_packed,
    grams_per_snp_lambda_packed,
    grams_shared_lambda,
    pair_products,
    pdot,
    permute_x_before_y,
)
from .solver import LambdaProblem, algebra, solve_lambda


def _use_fused(cfg: GwasConfig, X: torch.Tensor) -> bool:
    """Resolve the fused-kernel switch: auto means a float32 CUDA tensor."""
    if cfg.use_fused_kernel is not None:
        return cfg.use_fused_kernel
    return X.is_cuda and X.dtype == torch.float32


class NullFit(NamedTuple):
    """Null-model (no SNP) quantities shared by a whole phenotype's scan."""

    lambda_reml: torch.Tensor  # () REML lambda under y ~ W
    lambda_ml: torch.Tensor  # () ML lambda under y ~ W
    loglik_ml: torch.Tensor  # () ML log-likelihood at lambda_ml


class ImplicitCtx(NamedTuple):
    """Implicit low-rank kinship context for one association block.

    Marks that ``ev``/``W``/``y``/``X`` handed to :func:`assoc_block` live
    in the p_k-dimensional top eigenspace (rotated by U_top only; see
    core/lowrank.py::ImplicitBasis) and carries the raw (unrotated) Gram
    terms the complement correction needs.  ``S_raw`` is the (s, s) Gram of
    the raw [W, y] columns; ``vS_raw``/``vv_raw`` are the raw genotype
    cross/self terms, all lambda-independent and computed once per block.
    """

    eps: torch.Tensor  # () complement eigenvalue (the kinship ridge)
    n_total: int  # the true sample count n
    S_raw: torch.Tensor  # (s, s)
    vS_raw: torch.Tensor  # (B, s)
    vv_raw: torch.Tensor  # (B,)


class ImplicitMultiCtx(NamedTuple):
    """Implicit low-rank context shared by a multi-phenotype block.

    The raw Gram pieces factor over phenotypes -- W-blocks are shared and
    only the y column varies -- so the batched scan carries them split and
    assembles a per-phenotype :class:`ImplicitCtx` for each phenotype.
    """

    eps: torch.Tensor  # ()
    n_total: int
    WtW: torch.Tensor  # (c, c) raw covariate Gram
    WtY: torch.Tensor  # (c, k) raw covariate x phenotype cross terms
    YtY: torch.Tensor  # (k,)   raw phenotype self terms
    XtW: torch.Tensor  # (B, c) raw genotype x covariate cross terms
    XtY: torch.Tensor  # (B, k) raw genotype x phenotype cross terms
    vv: torch.Tensor  # (B,)   raw genotype self terms


def _raw_shared_gram(WtW: torch.Tensor, wty: torch.Tensor,
                     yty: torch.Tensor) -> torch.Tensor:
    """The (c+1, c+1) raw Gram of [W, y] from its factored pieces."""
    top = torch.cat([WtW, wty[:, None]], dim=1)
    bottom = torch.cat([wty, yty[None]])[None]
    return torch.cat([top, bottom], dim=0)


def _implicit_for_pheno(m: ImplicitMultiCtx, g: int) -> ImplicitCtx:
    """Assemble phenotype ``g``'s ImplicitCtx from the factored raw terms."""
    S_raw = _raw_shared_gram(m.WtW, m.WtY[:, g], m.YtY[g])
    vS_raw = torch.cat([m.XtW, m.XtY[:, g:g + 1]], dim=1)
    return ImplicitCtx(m.eps, m.n_total, S_raw, vS_raw, m.vv)


def _implicit_complement(implicit: ImplicitCtx, shared_c: torch.Tensor,
                         C_x: torch.Tensor) -> GramComplement:
    """Residual Grams R = T'T - C'C over columns [shared | x].  Exact in
    infinite precision because U_top's columns are orthonormal."""
    R_S = implicit.S_raw - pdot(shared_c.T, shared_c)
    R_vS = implicit.vS_raw - pdot(C_x.T, shared_c)
    R_vv = implicit.vv_raw - torch.sum(C_x * C_x, dim=0)
    n_comp = implicit.n_total - shared_c.shape[0]
    return GramComplement(implicit.eps, n_comp, R_S, R_vS, R_vv)


class AssocResult(NamedTuple):
    beta: torch.Tensor
    se_beta: torch.Tensor
    tau: torch.Tensor
    lam: torch.Tensor
    F_wald: torch.Tensor
    p_wald: Optional[torch.Tensor]
    p_lrt: Optional[torch.Tensor]
    p_score: Optional[torch.Tensor]
    F_score: Optional[torch.Tensor]
    lambda_ml: Optional[torch.Tensor]
    logl_H1: Optional[torch.Tensor]


def f_sf(F: torch.Tensor, dfd) -> torch.Tensor:
    """Survival function of F(1, dfd), evaluated on the host in float64.

    torch has no regularized incomplete beta, so this pulls F to the host
    (a device sync) and calls scipy's ``stats.f.sf`` as the reference does
    (lmm/lmm.py:482).  The result comes back in F's dtype and device.
    """
    Fh = np.maximum(F.detach().to("cpu", torch.float64).numpy(), 0.0)
    return torch.as_tensor(stats.f.sf(Fh, 1, dfd)).to(F.device, F.dtype)


def chi2_sf_1df(x: torch.Tensor) -> torch.Tensor:
    """chi^2(1) survival function: p = Gamma_upper(1/2, x/2)/Gamma(1/2)."""
    half = torch.full_like(x, 0.5)
    return torch.special.gammaincc(half, torch.clamp_min(x, 0.0) / 2.0)


def fit_null(ev, W, y, cfg: GwasConfig,
             implicit: Optional[ImplicitCtx] = None) -> NullFit:
    """Fit the null model y ~ W once per phenotype (for score/LRT tests).

    With ``implicit``, W/y are U_top-rotated and ``implicit.S_raw`` is the
    raw (s, s) Gram of [W, y]; the null design's residuals are carved out
    of it (shared = W, outcome = y).
    """
    n, c = W.shape
    comp = None
    if implicit is not None:
        n = implicit.n_total
        full_c = torch.cat([W, y[:, None]], dim=1)  # (p_k, c+1)
        R_full = implicit.S_raw - pdot(full_c.T, full_c)
        comp = GramComplement(implicit.eps, implicit.n_total - W.shape[0],
                              R_full[:c, :c], R_full[c:c + 1, :c],
                              R_full[c, c][None])
    pairs = pair_products(W)
    v = y[:, None]
    v2 = v * v
    prob_reml = LambdaProblem(ev, W, pairs, v, v2, n, c, False, True,
                              comp=comp)
    lam_reml, _ = solve_lambda(prob_reml, cfg)
    prob_ml = LambdaProblem(ev, W, pairs, v, v2, n, c, False, False,
                            comp=comp)
    lam_ml, logl_ml = solve_lambda(prob_ml, cfg)
    return NullFit(lam_reml[0], lam_ml[0], logl_ml[0])


def assoc_block(
    ev: torch.Tensor,  # (n,) clamped kinship eigenvalues
    W: torch.Tensor,  # (n, c) rotated covariates
    y: torch.Tensor,  # (n,) rotated phenotype
    X: torch.Tensor,  # (n, B) rotated genotype block
    cfg: GwasConfig,
    null: Optional[NullFit] = None,
    de: bool = False,
    pvalues: bool = True,
    implicit: Optional[ImplicitCtx] = None,
) -> AssocResult:
    """Run the LMM association tests for one SNP block.

    Standard mode fits  y = W a + x b + u + e  per SNP x; DE mode
    (reference lmm/lmm.py:498-532) swaps roles and fits  x = W a + y b + u + e.
    With ``implicit`` the inputs are U_top-rotated (p_k rows) and the
    complement enters through lambda-independent residual Grams.
    ``pvalues=False`` leaves ``p_wald``/``p_score`` as None: the F survival
    function runs on the host (:func:`f_sf`), and the driver computes the
    table's p-values there once, after the scan, instead of waiting for the
    card at every block.
    """
    n, c = W.shape
    if implicit is not None:
        n = implicit.n_total
    dtype = X.dtype
    shared = torch.cat([W, y[:, None]], dim=1)  # (n, c+1): [W, y]
    pairs = pair_products(shared)
    X2 = X * X
    fused = _use_fused(cfg, X)
    comp = (_implicit_complement(implicit, shared, X)
            if implicit is not None else None)

    # Lambda optimization with the full design.  Standard: design [W, x]
    # (permuted Gram order [W, x, y]); DE: design [W, y], outcome x.
    prob = LambdaProblem(ev, shared, pairs, X, X2, n, c + 1, not de, True,
                         fused, comp)
    lam_star, _ = solve_lambda(prob, cfg)

    # Final statistics at lambda*: one k=1 Gram build and the Wald step
    # (reml.wald), in the REML kernel on the card.
    if fused:
        packed = grams_per_snp_lambda_fused_packed(lam_star, ev, shared,
                                                   pairs, X, (1,))
    else:
        packed = grams_per_snp_lambda_packed(lam_star, ev, shared, pairs, X,
                                             X2, (1,))
    rows, x_ok = algebra(X)("wald", packed, lam_star, n=n, q=c + 1,
                            permute=not de, comp=comp)
    beta, se_beta, tau, lam_star, F_wald = rows
    df = float(n - c - 1)
    nan = float("nan")
    p_wald = f_sf(F_wald, df) if pvalues else None

    p_lrt = logl_H1 = lam_ml = None
    if "lrt" in cfg.tests:
        # GEMMA -lmm 2: ML lambda per SNP, D = 2(l1 - l0), chi^2(1).
        if null is None:
            raise ValueError("the LRT requires a null-model fit")
        prob_ml = LambdaProblem(ev, shared, pairs, X, X2, n, c + 1, not de,
                                False, fused, comp)
        lam_ml, logl_H1 = solve_lambda(prob_ml, cfg)
        D = 2.0 * (logl_H1 - null.loglik_ml)
        p_lrt = torch.where(x_ok, chi2_sf_1df(D), nan)
        lam_ml = torch.where(x_ok, lam_ml, nan)
        logl_H1 = torch.where(x_ok, logl_H1, nan)

    p_score = F_score = None
    if "score" in cfg.tests:
        # GEMMA -lmm 3: score statistic at the null REML lambda.
        if null is None:
            raise ValueError("the score test requires a null-model fit")
        grams0, _ = grams_shared_lambda(
            null.lambda_reml.to(dtype), ev, shared, pairs, X, X2, (1,),
            comp=comp)
        A1s = grams0[0]
        if not de:
            A1s = permute_x_before_y(A1s, c)
        sxPx, sxPy, syPy = reml.predictor_terms(A1s, c)
        # degenerate predictor -> NaN, not p = 0; also gated on the Wald
        # x_ok mask (a FULL NaN row for a collinear SNP)
        F_score = torch.where(
            x_ok & (sxPx > MIN_VAL),
            n * torch.square(sxPy) / torch.clamp_min(syPy * sxPx, MIN_VAL),
            nan,
        )
        p_score = f_sf(F_score, df) if pvalues else None

    return AssocResult(
        beta=beta,
        se_beta=se_beta,
        tau=tau,
        lam=lam_star,
        F_wald=F_wald,
        p_wald=p_wald,
        p_lrt=p_lrt,
        p_score=p_score,
        F_score=F_score,
        lambda_ml=lam_ml,
        logl_H1=logl_H1,
    )


def assoc_block_multi(
    ev: torch.Tensor,  # (n,)
    W: torch.Tensor,  # (n, c)
    Y_kn: torch.Tensor,  # (k, n) rotated phenotypes (e.g. genes in an eQTL scan)
    X: torch.Tensor,  # (n, B) rotated genotype block, shared by all k
    cfg: GwasConfig,
    null_stack: Optional[torch.Tensor] = None,  # (k, 3) stacked NullFit rows
    de: bool = False,
    implicit_multi: Optional[ImplicitMultiCtx] = None,
    pvalues: bool = True,
) -> dict:
    """Run :func:`assoc_block` for every phenotype against one block.

    The block is streamed and rotated (or, with ``implicit_multi``,
    prepared) once by the caller for all k phenotypes -- the answer to the
    reference's per-gene SLURM array (experiments/1000G/run_pyGEMMA.sh:43-52).
    Returns a dict of (k, B) tensors, one per non-None AssocResult field.

    One loop over phenotypes serves every k.  The JAX package unrolls up to
    12 phenotypes and vmaps beyond, because a Pallas kernel has no vmap
    rule; here the fused kernel is an ordinary call, so each phenotype
    keeps it (``_use_fused`` decides as for one phenotype) and no (k, B, n)
    temporaries exist.
    """
    outs = []
    for g in range(Y_kn.shape[0]):
        ictx = (_implicit_for_pheno(implicit_multi, g)
                if implicit_multi is not None else None)
        null = NullFit(*null_stack[g]) if null_stack is not None else None
        res = assoc_block(ev, W, Y_kn[g], X, cfg, null=null, de=de,
                          pvalues=pvalues, implicit=ictx)
        outs.append({k: v for k, v in res._asdict().items() if v is not None})
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def fit_null_multi(ev, W, Y_kn, cfg: GwasConfig,
                   implicit_multi: Optional[ImplicitMultiCtx] = None
                   ) -> torch.Tensor:
    """:func:`fit_null` for each phenotype -> (k, 3) stacked rows
    (lambda_reml, lambda_ml, loglik_ml)."""
    rows = []
    for g in range(Y_kn.shape[0]):
        ictx = None
        if implicit_multi is not None:
            m = implicit_multi
            S_raw = _raw_shared_gram(m.WtW, m.WtY[:, g], m.YtY[g])
            # the per-SNP residual fields are unused by the null fit
            ictx = ImplicitCtx(m.eps, m.n_total, S_raw,
                               S_raw.new_zeros((1, S_raw.shape[0])),
                               S_raw.new_zeros((1,)))
        nf = fit_null(ev, W, Y_kn[g], cfg, implicit=ictx)
        rows.append(torch.stack([nf.lambda_reml, nf.lambda_ml, nf.loglik_ml]))
    return torch.stack(rows)
