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
counts the evaluations.  With tracing on (utils/profiling.py) a solve is a
``lambda`` span and each wait a ``sync`` span.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import GwasConfig
from ..utils import profiling
from . import reml
from .grams import (
    GramComplement,
    grams_per_snp_lambda,
    grams_per_snp_lambda_fused,
    grams_per_snp_lambda_slots,
    grams_shared_lambda,
    grams_shared_multi,
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


_KS = {"d1": (1, 2), "newton": (1, 2, 3), "lik": (1,)}


def evaluate(problem: LambdaProblem, lam, need: str, shared_lam):
    """Evaluate d1 / (d1, d2) / loglik at ``lam`` for every SNP in the block.

    ``shared_lam=True`` takes a scalar lambda (GEMM fast path);
    ``shared_lam="multi"`` takes a (G,) lambda grid and returns (G, B)
    outputs from one wide GEMM; otherwise ``lam`` is (B,) or (B, R).
    ``evaluate.count`` counts the calls.
    """
    evaluate.count += 1
    ks = _KS[need]
    kw = dict(want_logh=need == "lik", comp=problem.comp)
    args = (problem.ev, problem.shared, problem.pairs, problem.v)
    if shared_lam == "multi":
        grams, sums = grams_shared_multi(lam, *args, problem.v2, ks, **kw)
        lam = lam[:, None]  # broadcast (G, 1) against (G, B) scalars
    elif shared_lam:
        grams, sums = grams_shared_lambda(lam, *args, problem.v2, ks, **kw)
    elif problem.fused:
        grams, sums = grams_per_snp_lambda_fused(lam, *args, ks, **kw)
    elif lam.ndim == 2:
        grams, sums = grams_per_snp_lambda_slots(lam, *args, problem.v2, ks,
                                                 **kw)
    else:
        grams, sums = grams_per_snp_lambda(lam, *args, problem.v2, ks, **kw)
    if problem.permute:
        c = problem.q - 1
        grams = tuple(permute_x_before_y(A, c) for A in grams)
    A1 = grams[0]
    A2 = grams[1] if len(grams) > 1 else None
    A3 = grams[2] if len(grams) > 2 else None
    scal = reml.reml_scalars(
        A1, A2, A3, sums, problem.q, need_third=(need == "newton")
    )
    n, q = problem.n, problem.q
    if need == "lik":
        if problem.restricted:
            return reml.loglik_restricted(
                lam, n, q, scal.yPy, sums.sum_logh, scal.logdet_G1
            )
        return reml.loglik_ml(lam, n, scal.yPy, sums.sum_logh)
    if need == "d1":
        if problem.restricted:
            return reml.d1_restricted(lam, n, q, scal.yPy, scal.yPPy, scal.trP)
        return reml.d1_ml(lam, n, scal.yPy, scal.yPPy, sums.sum_d)
    # need == "newton"
    if problem.restricted:
        d1 = reml.d1_restricted(lam, n, q, scal.yPy, scal.yPPy, scal.trP)
        d2 = reml.d2_restricted(
            lam, n, q, scal.yPy, scal.yPPy, scal.yPPPy, scal.trP, scal.trPP
        )
    else:
        d1 = reml.d1_ml(lam, n, scal.yPy, scal.yPPy, sums.sum_d)
        d2 = reml.d2_ml(
            lam, n, scal.yPy, scal.yPPy, scal.yPPPy, sums.sum_d, sums.sum_d2
        )
    return d1, d2


evaluate.count = 0


def _sign(x):
    """Sign with sign(0) = +1, mirroring copysignf(1.0, x) (pyx:174)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _nan_sign(x):
    """Sign that keeps NaN as NaN (``torch.sign`` maps NaN to 0 on some
    builds): Newton's three-way sign product must be NaN for a NaN lane so
    the lane stops on the NaN guard, not on the sign test."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


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
    ``lambda`` span with its root batches, Newton iterations and
    evaluations."""
    evals = evaluate.count
    with profiling.span("lambda") as sp:
        out, batches, newton = _solve_lambda(problem, cfg)
        sp.set(batches=batches, newton=newton,
               evals=evaluate.count - evals)
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
    # bracket) root problem is *gathered* into the lanes of a single-slot
    # (B, 1) problem and ceil(total_roots / B) such batches are walked (none
    # when the block has no roots at all).  Compaction only changes *where*
    # each root is computed, not *what* is computed.
    def refine_body(prob, lo0_r, hi0_r, valid_r, flo):
        """Bisection + Newton + likelihood for one slot layout (B, r)."""
        # masked GEOMETRIC bisection (replaces brentq, pyx:176-182): the
        # geometric midpoint halves the bracket's log-width each step
        lo, hi = lo0_r, hi0_r
        for _ in range(cfg.bisect_iters):
            mid = torch.sqrt(lo * hi)
            sm = _sign(evaluate(prob, mid, "d1", False))
            go_right = sm == flo  # root is in [mid, hi]
            lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
        lam_r = torch.sqrt(lo * hi)

        # masked safeguarded Newton (pyx:1349-1416); updates are masked, so
        # the early exit once every lane has stopped changes nothing
        nonlocal newton
        done = ~valid_r
        for _ in range(cfg.newton_iters):
            if host_value(torch.all(done)):
                break
            newton += 1
            d1, d2 = evaluate(prob, lam_r, "newton", False)
            ratio = d1 / d2
            # pyx:1392 -- stop without updating when the three-way sign
            # product is <= 0 (covers d1==0, d2==0; NaN falls through to the
            # NaN guard exactly as in the reference).
            bad_sign = (_nan_sign(ratio) * _nan_sign(d1) * _nan_sign(d2)) <= 0
            cand = lam_r - ratio
            bad_num = torch.isnan(cand) | torch.isinf(cand)
            # pyx:1398-1404 -- an out-of-bracket step BREAKS WITHOUT
            # updating (the reference's clamp assigns a dead local)
            oob = (cand < lo0_r) | (cand > hi0_r)
            rel = torch.abs(cand - lam_r) / torch.abs(lam_r)
            do_upd = (~done) & (~bad_sign) & (~bad_num) & (~oob)
            lam_r = torch.where(do_upd, cand, lam_r)
            done = done | bad_sign | bad_num | oob | (rel < cfg.newton_rtol)

        # likelihood at the refined roots (pyx:186-188)
        lik_r = evaluate(prob, lam_r, "lik", False)  # (B, r)
        lik_r = torch.where(valid_r, lik_r, -torch.inf)
        return lam_r, lik_r

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
        valid_c = flat_valid[sel][:, None]  # (B, 1)
        comp_c = None
        if problem.comp is not None:
            # the per-SNP residual terms travel with their lanes
            comp_c = problem.comp._replace(R_vS=problem.comp.R_vS[snp_idx],
                                           R_vv=problem.comp.R_vv[snp_idx])
        prob_c = problem._replace(v=problem.v[:, snp_idx],
                                  v2=problem.v2[:, snp_idx], comp=comp_c)
        lam_c, lik_c = refine_body(
            prob_c, lo0_f[sel][:, None], hi0_f[sel][:, None],
            valid_c, flo_f[sel][:, None],
        )
        lam_f[sel] = torch.where(valid_c[:, 0], lam_c[:, 0], 1.0).to(dtype)
        lik_f[sel] = lik_c[:, 0].to(dtype)
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
