"""Vectorized variance-ratio (lambda) optimizer, batched over SNPs.

The reference optimizes lambda per SNP with data-dependent control flow:
decade-bracket scan -> scipy brentq (rtol=0.1) -> safeguarded Newton
(reference pygemma_model/pygemma_model.pyx:135-194, :1349-1416).  Here the
same semantics run as masked updates over the whole SNP block:

1.  Evaluate d ell/d lambda at the 11 decade points 10^-5..10^5 with a
    *shared* lambda (pure-GEMM path) and detect sign changes per SNP.
2.  For EVERY sign-change bracket per SNP (an optional ``cfg.max_roots`` cap
    exists for benchmarking), run a fixed number of masked bisection steps
    (replacing brentq) followed by masked safeguarded Newton steps
    replicating the reference's stopping rules (ratio-sign break, bracket
    clamping, rel-tol 1e-5; pyx:1392-1411).  Root problems are refined in
    compacted batches of B lanes, so blocks with few roots pay for one pass
    and blocks with none pay for nothing.
3.  Evaluate the (restricted) likelihood at every refined root plus the two
    bracket endpoints and keep the argmax -- the reference's multi-root
    resolution (pyx:186-194) -- with candidate order chosen so argmax
    tie-breaking matches the reference's strict-improvement scan.

``grid=True`` reproduces the pure grid search (pyx:99-132).

The loops are host loops.  They wait for the device at two places only:
the number of root batches (once per solve) and Newton's early exit (once
per iteration); :func:`host_value` counts both, and ``evaluate.count``
counts the evaluations.  Each evaluation is one Gram build and one call of
the REML kernel (ops/reml_kernel.py), which also takes the bisection's or
Newton's step, on tensors on the card, or of its plain PyTorch version,
:func:`evaluate_plain`, on CPU tensors (:func:`algebra`).  With tracing on
(utils/profiling.py) a solve is a ``lambda`` span, with its evaluations and
those the kernel ran (``kernel_evals``), and each wait a ``sync`` span.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import GwasConfig
from ..ops.reml_kernel import KMAX, reml_kernel
from ..utils import profiling
from . import reml
from .grams import (
    GramComplement,
    PackedGrams,
    _complement_correct,
    assemble,
    grams_per_snp_lambda_fused_packed,
    grams_per_snp_lambda_packed,
    grams_shared_lambda_packed,
    grams_shared_multi_packed,
    permute_x_before_y,
)


def host_value(t: torch.Tensor):
    """Pull a scalar to the host (a device sync on CUDA), counted in
    ``host_value.count``."""
    host_value.count += 1
    with profiling.span("sync"):
        return t.item()


host_value.count = 0


class LambdaProblem(NamedTuple):
    """One lambda-optimization problem over a block of B per-SNP columns.

    ``shared``: (n, s) columns shared across the block; ``v``: (n, B) per-SNP
    column; ``pairs``: pair products of ``shared``.  ``q`` is the design width
    the projection removes; with ``permute=True`` the design is
    [shared[:, :q-1], v] (standard GWAS: shared=[W, y], v=x, design=[W, x]);
    with ``permute=False`` it is shared[:, :q] (null model / DE mode).
    ``restricted`` selects REML vs ML.  ``fused=True`` routes per-SNP-lambda
    evaluations through the fused Gram kernel (ops/gram_kernel.py).

    ``comp`` (optional) marks an implicit low-rank problem: ``ev``/``shared``
    /``pairs``/``v``/``v2`` then live in the p_k-dimensional top eigenspace
    (rotated by U_top only) while ``comp`` carries the complement eigenvalue
    and the lambda-independent residual Grams
    (:class:`pygemma_tpu_torch.core.grams.GramComplement`); ``n`` stays the
    true sample count.
    """

    ev: torch.Tensor
    shared: torch.Tensor
    pairs: torch.Tensor
    v: torch.Tensor
    v2: torch.Tensor
    n: int
    q: int
    permute: bool
    restricted: bool
    fused: bool = False
    comp: Optional[GramComplement] = None


def _sign(x):
    """Sign with sign(0) = +1, mirroring copysignf(1.0, x) (pyx:174)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _nan_sign(x):
    """Sign that keeps NaN as NaN (``torch.sign`` maps NaN to 0 on some
    builds): Newton's three-way sign product must be NaN for a NaN lane so
    the lane stops on the NaN guard, not on the sign test."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


class Bisect(NamedTuple):
    """A geometric bisection step's state, (B,) each, updated in place: the
    bracket and the sign of d1 at its low end."""

    lo: torch.Tensor
    hi: torch.Tensor
    flo: torch.Tensor


class Newton(NamedTuple):
    """A safeguarded Newton step's state: the bracket a step may not leave
    (B,), the stopped lanes (B,) bool (updated in place) and the
    relative-step tolerance."""

    lo0: torch.Tensor
    hi0: torch.Tensor
    done: torch.Tensor
    rtol: float


def bisect_step(d1, lam, step: Bisect) -> None:
    """Masked geometric bisection (replaces brentq, pyx:176-182), in place:
    the root is in [mid, hi] when d1 at the midpoint ``lam`` keeps the low
    end's sign; ``lam`` becomes the next midpoint, which halves the
    bracket's log-width."""
    go_right = _sign(d1) == step.flo
    lo = torch.where(go_right, lam, step.lo)
    hi = torch.where(go_right, step.hi, lam)
    step.lo.copy_(lo)
    step.hi.copy_(hi)
    lam.copy_(torch.sqrt(lo * hi))


def newton_step(d1, d2, lam, step: Newton) -> None:
    """Masked safeguarded Newton (pyx:1349-1416), in place on ``lam`` and
    ``step.done``; a stopped lane never moves again."""
    ratio = d1 / d2
    # pyx:1392 -- stop without updating when the three-way sign product is
    # <= 0 (covers d1==0, d2==0; NaN falls through to the NaN guard exactly
    # as in the reference).
    bad_sign = (_nan_sign(ratio) * _nan_sign(d1) * _nan_sign(d2)) <= 0
    cand = lam - ratio
    bad_num = torch.isnan(cand) | torch.isinf(cand)
    # pyx:1398-1404 -- an out-of-bracket step BREAKS WITHOUT updating (the
    # reference's clamp assigns a dead local)
    oob = (cand < step.lo0) | (cand > step.hi0)
    rel = torch.abs(cand - lam) / torch.abs(lam)
    do_upd = (~step.done) & (~bad_sign) & (~bad_num) & (~oob)
    lam.copy_(torch.where(do_upd, cand, lam))
    step.done.logical_or_(bad_sign | bad_num | oob | (rel < step.rtol))


def evaluate_plain(need: str, packed: PackedGrams, lam, *, n: int, q: int,
                   permute: bool, restricted: bool = True,
                   comp: Optional[GramComplement] = None, step=None,
                   valid=None):
    """The REML kernel's plain PyTorch version, same contract
    (ops/reml_kernel.py): the Grams assembled and corrected for the
    complement, ``core/reml.py``'s algebra, then :func:`bisect_step`,
    :func:`newton_step`, the likelihood's -inf for the lanes ``valid``
    drops, or the Wald statistics (:func:`reml.wald`)."""
    grid = lam.ndim == 1 and packed.vv.ndim == 3  # (G,) lambdas, (G, B) lanes
    grams, sums = assemble(packed), packed.sums
    if comp is not None:
        layout = ("scalar" if lam.ndim == 0 else "multi" if grid
                  else "per_snp")
        grams, sums = _complement_correct(
            grams, sums, range(1, len(grams) + 1), comp, lam, layout,
            need == "lik")
    if permute:
        grams = tuple(permute_x_before_y(A, q - 1) for A in grams)
    if need == "wald":
        return reml.wald(grams[0], sums, lam, n, q - 1)
    if grid:
        lam = lam[:, None]  # broadcast (G, 1) against (G, B) scalars
    A2 = grams[1] if need != "lik" else None
    A3 = grams[2] if need == "newton" else None
    scal = reml.reml_scalars(grams[0], A2, A3, sums, q,
                             need_third=need == "newton")
    if need == "lik":
        if restricted:
            lik = reml.loglik_restricted(lam, n, q, scal.yPy, sums.sum_logh,
                                         scal.logdet_G1)
        else:
            lik = reml.loglik_ml(lam, n, scal.yPy, sums.sum_logh)
        return lik if valid is None else torch.where(valid, lik, -torch.inf)
    if restricted:
        d1 = reml.d1_restricted(lam, n, q, scal.yPy, scal.yPPy, scal.trP)
    else:
        d1 = reml.d1_ml(lam, n, scal.yPy, scal.yPPy, sums.sum_d)
    if need == "d1":
        return d1 if step is None else bisect_step(d1, lam, step)
    if restricted:
        d2 = reml.d2_restricted(lam, n, q, scal.yPy, scal.yPPy, scal.yPPPy,
                                scal.trP, scal.trPP)
    else:
        d2 = reml.d2_ml(lam, n, scal.yPy, scal.yPPy, scal.yPPPy, sums.sum_d,
                        sums.sum_d2)
    return (d1, d2) if step is None else newton_step(d1, d2, lam, step)


def algebra(x: torch.Tensor):
    """What evaluates packed Grams next to ``x``: the REML kernel on the
    card, :func:`evaluate_plain` on the CPU."""
    return reml_kernel if x.is_cuda else evaluate_plain


def evaluate(problem: LambdaProblem, lam, need: str, shared_lam, step=None,
             valid=None):
    """Evaluate d1 / (d1, d2) / loglik at ``lam`` for every SNP in the block.

    ``shared_lam=True`` takes a scalar lambda (GEMM fast path);
    ``shared_lam="multi"`` takes a (G,) lambda grid and returns (G, B)
    outputs from one wide GEMM; otherwise ``lam`` is (B,).  With ``step``
    (:class:`Bisect` after "d1", :class:`Newton` after "newton") the
    search's step is taken in place instead and None returned; ``valid``
    sets the likelihood of the other lanes to -inf.  ``evaluate.count``
    counts the calls.
    """
    evaluate.count += 1
    ks = tuple(range(1, KMAX[need] + 1))
    want_logh = need == "lik"
    args = (problem.ev, problem.shared, problem.pairs, problem.v)
    if shared_lam == "multi":
        packed = grams_shared_multi_packed(lam, *args, problem.v2, ks,
                                           want_logh)
    elif shared_lam:
        packed = grams_shared_lambda_packed(lam, *args, problem.v2, ks,
                                            want_logh)
    elif problem.fused:
        packed = grams_per_snp_lambda_fused_packed(lam, *args, ks, want_logh)
    else:
        packed = grams_per_snp_lambda_packed(lam, *args, problem.v2, ks,
                                             want_logh)
    return algebra(problem.v)(
        need, packed, lam, n=problem.n, q=problem.q, permute=problem.permute,
        restricted=problem.restricted, comp=problem.comp, step=step,
        valid=valid)


evaluate.count = 0


@functools.lru_cache(maxsize=64)
def _decade_table(lo_pow: float, n_grid: int, dtype: torch.dtype,
                  device: str) -> torch.Tensor:
    """The decade points 10^lo_pow .. 10^(lo_pow+n_grid-1), rounded from
    float64 into ``dtype`` once per (settings, device) -- the correctly
    rounded values, which are what the reference's ``10 ** k`` gives."""
    return torch.tensor([10.0 ** (lo_pow + i) for i in range(n_grid)],
                        dtype=dtype, device=device)


def solve_lambda(problem: LambdaProblem, cfg: GwasConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (lambda_star, loglik_star), each (B,).  Traced as a
    ``lambda`` span with its root batches, Newton iterations, evaluations
    and the evaluations the REML kernel ran."""
    evals, launches = evaluate.count, reml_kernel.launches
    with profiling.span("lambda") as sp:
        out, batches, newton = _solve_lambda(problem, cfg)
        sp.set(batches=batches, newton=newton,
               evals=evaluate.count - evals,
               kernel_evals=reml_kernel.launches - launches)
    return out


def _solve_lambda(problem: LambdaProblem, cfg: GwasConfig):
    """(solve_lambda's result, root batches, Newton iterations run)."""
    dtype = problem.v.dtype
    device = problem.v.device
    B = problem.v.shape[1]
    n_grid = cfg.n_grid
    decades = _decade_table(float(cfg.lambda_pow_low), n_grid, dtype,
                            str(device))

    if cfg.grid:
        # Reference grid path (pyx:99-132): endpoints first (low endpoint wins
        # ties), then each decade point with strict improvement.
        cand = torch.cat([decades[:1], decades[-1:], decades[:-1]])
        liks = evaluate(problem, cand, "lik", "multi")  # (n_cand, B)
        liks = liks.expand(cand.shape[0], B).T
        best = torch.argmax(liks, dim=1)
        lam_star = cand[best]
        return (lam_star, torch.gather(liks, 1, best[:, None])[:, 0]), 0, 0

    # --- stage 1: one wide-GEMM decade sweep of d1 -------------------------
    d1_grid = evaluate(problem, decades, "d1", "multi")  # (n_grid, B)
    d1_grid = d1_grid.expand(n_grid, B).T  # (B, n_grid)
    signs = _sign(d1_grid)
    sc = signs[:, :-1] * signs[:, 1:] < 0  # (B, n_grid - 1) sign changes

    # --- stage 2: stage the sign-change brackets per SNP --------------------
    # max_roots=0 (default) stages EVERY decade bracket, matching the
    # reference's exhaustive bracket scan (pyx:154-194); a positive value
    # caps the brackets refined per SNP.
    n_brk = n_grid - 1
    R = min(cfg.max_roots, n_brk) if cfg.max_roots > 0 else n_brk
    # bool argsort is not defined everywhere: sort the uint8 "no root" flag
    order = torch.argsort((~sc).to(torch.uint8), dim=1, stable=True)[:, :R]
    valid = torch.gather(sc, 1, order)  # (B, R)
    lo0 = decades[order]
    hi0 = decades[order + 1]
    sign_lo = torch.gather(signs, 1, order)

    ep_liks = evaluate(
        problem, torch.cat([decades[:1], decades[-1:]]), "lik", "multi"
    ).expand(2, B)  # (2, B)

    # --- stages 3-5: root refinement in compacted batches.  Every (snp,
    # bracket) root problem is *gathered* into the lanes of a (B,) problem
    # and ceil(total_roots / B) such batches are walked (none
    # when the block has no roots at all).  Compaction only changes *where*
    # each root is computed, not *what* is computed.
    def refine_body(prob, lo0_r, hi0_r, valid_r, flo):
        """Bisection + Newton + likelihood for one batch of (B,) root
        problems."""
        # masked GEOMETRIC bisection (replaces brentq, pyx:176-182)
        lo, hi = lo0_r.clone(), hi0_r.clone()
        lam_r = torch.sqrt(lo * hi)
        for _ in range(cfg.bisect_iters):
            evaluate(prob, lam_r, "d1", False, step=Bisect(lo, hi, flo))

        # masked safeguarded Newton (pyx:1349-1416); updates are masked, so
        # the early exit once every lane has stopped changes nothing
        nonlocal newton
        done = ~valid_r
        step = Newton(lo0_r, hi0_r, done, cfg.newton_rtol)
        for _ in range(cfg.newton_iters):
            if host_value(torch.all(done)):
                break
            newton += 1
            evaluate(prob, lam_r, "newton", False, step=step)

        # likelihood at the refined roots (pyx:186-188)
        return lam_r, evaluate(prob, lam_r, "lik", False, valid=valid_r)

    newton = 0
    # Lane l of a compacted batch works on SNP sel[l] // R, bracket slot
    # sel[l] % R; lanes past the last root are masked invalid (their Newton
    # state starts "done" and their likelihood is forced to -inf).  Each
    # flat slot appears in exactly one batch, so the scatters never collide.
    flat_valid = valid.reshape(-1)  # (B * R,) SNP-major
    sorted_idx = torch.argsort((~flat_valid).to(torch.uint8), stable=True)
    n_batches = (int(host_value(torch.sum(flat_valid))) + B - 1) // B
    lo0_f = lo0.reshape(-1)
    hi0_f = hi0.reshape(-1)
    flo_f = sign_lo.reshape(-1)
    lam_f = torch.ones((B * R,), dtype=dtype, device=device)
    lik_f = torch.full((B * R,), -torch.inf, dtype=dtype, device=device)
    for k in range(n_batches):
        sel = sorted_idx[k * B:(k + 1) * B]
        snp_idx = sel // R
        valid_c = flat_valid[sel]
        comp_c = None
        if problem.comp is not None:
            # the per-SNP residual terms travel with their lanes
            comp_c = problem.comp._replace(R_vS=problem.comp.R_vS[snp_idx],
                                           R_vv=problem.comp.R_vv[snp_idx])
        prob_c = problem._replace(v=problem.v[:, snp_idx],
                                  v2=problem.v2[:, snp_idx], comp=comp_c)
        lam_c, lik_c = refine_body(prob_c, lo0_f[sel], hi0_f[sel], valid_c,
                                   flo_f[sel])
        lam_f[sel] = torch.where(valid_c, lam_c, 1.0)
        lik_f[sel] = lik_c
    lam_r = lam_f.reshape(B, R)
    lik_r = lik_f.reshape(B, R)

    # candidate order: endpoints first (low wins ties), then roots in
    # bracket order -- matches the reference's strict-improvement scan.
    lams = torch.cat(
        [decades[:1].expand(B, 1), decades[-1:].expand(B, 1), lam_r], dim=1
    )
    liks = torch.cat([ep_liks.T.to(dtype), lik_r], dim=1)
    best = torch.argmax(liks, dim=1)
    lam_star = torch.gather(lams, 1, best[:, None])[:, 0]
    lik_star = torch.gather(liks, 1, best[:, None])[:, 0]
    return (lam_star, lik_star), n_batches, newton
