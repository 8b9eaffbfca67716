"""Host-driven spectral divide-and-conquer eigendecomposition.

The JAX package's ``core/eigh_dc.py``, on torch tensors: the O(n^3) work is
full-size GEMMs (``torch.matmul``: the sign iteration in float64, DGEMM on
the card; the rest in A's dtype, FP32 SGEMM on the card with TF32 off), and
factorizations only run at the subspace size:

1.  sign(A - sigma I) via a GEMM-only matrix-sign iteration (a
    Polar-Express-style degree-5 Newton-Schulz schedule);
2.  spectral projectors P_lo/P_hi -> invariant-subspace bases via
    randomized range finding with spare columns and a Rayleigh-Ritz step on
    the projector, then CholeskyQR2;
3.  Rayleigh-Ritz blocks V' A V solved by ``torch.linalg.eigh`` at their own
    size once they fit ``max_block``;
4.  recurse on any block still larger than the cap; back-transform
    eigenvectors with one GEMM per block, and certify every eigenpair at the
    root with one GEMM (:func:`_pair_residuals`).

On an H100 cuSOLVER decomposes every n that fits, with less memory (this
path holds about 8 n^2 values at its peak), so ``eigh_backend="auto"`` never
routes here; ``"dc"`` runs it when asked.  The split is value-based with the
rank read off trace(P); imbalanced splits simply recurse deeper.

What the JAX module needed only to bound XLA compiles is not carried: the
leaf eigh runs at the block's own size (no bucket padding), the panel QR's
last panel is narrower (no random pad columns), and an error raises (no
compile-service retry).  Random draws come from ``torch.Generator``s seeded
with the JAX module's integer formulas, in A's dtype, so the bases differ
from the JAX package's; the eigenvalues do not.

Five defects of the JAX module are not inherited, each held by a test in
tests/test_torch_eigh_dc.py (the last at the card's n = 16,384 by
chip_smoke.py's phase 12): a NaN range attempt kept as the best against
a finite one; a repair span cut by column index; CholeskyQR2 shifting both
of its passes (orthogonality stops near k * eps); a range find without
spare columns, which splits an unconverged near-sigma direction and mixes
distant eigenvalues into the other block (:func:`_orthonormal_range`); and
a float32 sign iteration, whose rounding leaks ~1e-3 between the blocks of
a split at n = 16,384 (_SIGN_DTYPE).
``PYGEMMA_TPU_DC_VERBOSE=1`` prints one line per split stage to stdout.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import check_matmul_precision
from ..parallel.slabs import WHOLE, SlabGroup, Slabs

#: ``max_block``'s default: the JAX module's largest built-in eigh, kept so
#: that the recursion has the same shape on both packages
DIRECT_EIGH_MAX = 8192

#: GEMM-only sign-iteration schedule: (a, b, c) applies X <- aX + bX^3 + cX^5.
#: The two leading Newton-Schulz rows are globally safe for any |x| <=
#: sqrt(3) and land the spectrum inside [0, 1] even when the norm estimate
#: undershot (power iteration converges slowly on clustered top
#: eigenvalues); the quintic rows would DIVERGE for |x| > ~1.01.  The steep
#: quintic rows then pull tiny values toward 1 fast (Polar-Express-style
#: coefficients); the tail rows are Newton-Schulz polish.  The sign steps
#: need at least full float32 products (_SIGN_DTYPE): a reduced-precision
#: GEMM's rounding alone pushes the scaled spectrum past the quintic rows'
#: |x| <= ~1.01 region and the iterate blows up to NaN.
_SIGN_SCHEDULE = (
    (1.5, -0.5, 0.0),
    (1.5, -0.5, 0.0),
    (8.28721201814563, -23.595886519098837, 17.300387312530933),
    (4.107059111542203, -2.9478499167379106, 0.5448431082926601),
    (3.9486908534822946, -2.908902115962949, 0.5518191394370137),
    (3.3184196573706015, -2.488488024314874, 0.51004894012372),
    (2.300652019954817, -1.6689039845747493, 0.4188073119525673),
    (1.891301407787398, -1.2679958271945868, 0.37680408948524835),
    (1.8750014808534479, -1.2500016453999487, 0.3750001645474248),
    (1.875, -1.25, 0.375),
    (1.5, -0.5, 0.0),
    (1.5, -0.5, 0.0),
    (1.5, -0.5, 0.0),
)

#: dtype of the sign iteration, whatever A's.  In float32 at n of ~8,192
#: and more, its rounding tilts the projector's eigenvectors by 1e-4 to 1e-3
#: (the JAX module's choice): every split then leaks that much between its
#: blocks, spread too thin for the coupling gate, which reads the largest
#: entry of the pencil's off-diagonal block, and per-pair residuals reach
#: ~1e-3 of max|ev| at n = 16,384 on the card.  In float64 the leak at
#: n = 8,192 is 1e-7.  On Hopper a DGEMM runs on the FP64 tensor cores at
#: about the rate of a float32 SGEMM on the FP32 pipes (TF32 off).
_SIGN_DTYPE = torch.float64

#: width above which the Householder route orthonormalizes in panels
_PANEL_QR_MAX_DIRECT = 4096
_PANEL = 2048

#: spare columns of the range find (see :func:`_orthonormal_range`)
_RANGE_OVERSAMPLE = 64


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed & 0x7FFFFFFF)


def _randn(shape, like: torch.Tensor, seed: int) -> torch.Tensor:
    """Gaussians in ``like``'s dtype, drawn on its device."""
    return torch.randn(shape, generator=_generator(like.device, seed),
                       device=like.device, dtype=like.dtype)


def _eye_residual(X2: torch.Tensor, rows=WHOLE) -> torch.Tensor:
    """max |X2 - I| with one n x n temporary."""
    R = X2.abs()
    rows.diag(R).copy_(rows.diag(X2) - 1.0).abs_()
    return rows.amax(R)


def _shift_scale(A, sigma: float, seed: int, boost: float,
                 rows=WHOLE) -> torch.Tensor:
    """H = A - sigma I in _SIGN_DTYPE, scaled so its spectrum sits safely
    inside [-1, 1].

    The scale is a power-iteration estimate of ||H||_2 (a block of 8
    vectors, 24 sweeps -- tight to ~1e-3 for symmetric H) times a 1.05
    safety margin: the quintic sign steps DIVERGE for |x| > ~1.01, and the
    sqrt(n) slack of a Frobenius bound would instead start the iteration so
    deep in [0, eps] that it stalls."""
    n = A.shape[1]
    H = A.to(_SIGN_DTYPE, copy=True)
    rows.diag(H).sub_(sigma)
    tiny = torch.finfo(H.dtype).tiny
    V = rows.take(_randn((n, 8), H, seed))
    for _ in range(24):
        V = rows.mm(H, V)
        V = V / (rows.colnorm(V, keepdim=True) + tiny)
    est = rows.colnorm(rows.mm(H, V)).amax()
    return H.div_(1.05 * boost * est + tiny)


def _sign_step(X, a: float, b: float, c: float, rows=WHOLE):
    """One quintic sign step PLUS the convergence residual of the INPUT,
    read off the X^2 that the step computes anyway -- so monitoring
    convergence costs zero extra GEMMs."""
    X2 = rows.mm(X, X)
    resid_in = _eye_residual(X2, rows)
    X3 = rows.mm(X, X2)
    X5 = rows.mm(X3, X2)
    del X2
    return X5.mul_(c).add_(X3, alpha=b).add_(X, alpha=a), resid_in


def _sign_step_ns(X, a: float, b: float, rows=WHOLE):
    """Cubic (Newton-Schulz) step in TWO GEMMs via Horner:
    aX + bX^3 = X (aI + b X^2).  The schedule's leading/tail NS rows and
    every polish round only need the cubic, which saves one n^3 GEMM each
    against the quintic step."""
    X2 = rows.mm(X, X)
    resid_in = _eye_residual(X2, rows)
    rows.diag(X2.mul_(b)).add_(a)
    return rows.mm(X, X2), resid_in


def _sign_residual(X, rows=WHOLE) -> torch.Tensor:
    """||X^2 - I||_inf-ish convergence measure (one GEMM + reduction)."""
    return _eye_residual(rows.mm(X, X), rows)


def _ritz_sketch(A, Om, rows=WHOLE):
    """(Om'A Om, Om'Om) pencil blocks for a host-side generalized Ritz
    estimate of the spectrum (two GEMMs, no device factorization).  ``Om``
    is whole on every rank."""
    Y = torch.matmul(A, Om)
    Om = rows.take(Om)
    return rows.gram(Om, Y), rows.gram(Om, Om)


def _spectral_quantile(A, q: float, seed: int, k: int = 512, rows=WHOLE):
    """Estimate a split point near the q-quantile of A's spectrum from the
    Ritz values of a random k-dim subspace (generalized eigenproblem
    solved on the host at k^2, with scipy).

    GAP PREFERENCE: when a pronounced spectral gap exists near the target
    quantile, sigma is placed at ITS midpoint instead of the raw quantile.
    A sigma INSIDE a (near-)degenerate cluster stalls the sign iteration
    on the whole cluster (eigenvalues AT sigma have no sign), and the
    resulting pseudo-projector can mix one cluster direction into the
    wrong Rayleigh block (K = GG'/p + eps I with n > p has an (n - p)-fold
    eps eigenvalue that can span the median).  Continuous bulks (MP-law
    Grams) have no dominant gap and keep the plain quantile.  The host's
    pencil is solved once, on the group's first rank."""
    n = A.shape[1]
    k = min(k, n)
    Om = _randn((n, k), A, seed)
    H, B = _ritz_sketch(A, Om, rows)
    del Om
    return rows.on_leader(_ritz_split_point, H, B, q)


def _ritz_split_point(H, B, q: float):
    """The split point from the Ritz pencil (H, B) of
    :func:`_spectral_quantile` (None when the pencil cannot be solved)."""
    import scipy.linalg

    k = H.shape[0]
    Hh = H.cpu().numpy().astype(np.float64)
    Bh = B.cpu().numpy().astype(np.float64)
    Hh = (Hh + Hh.T) / 2
    Bh = (Bh + Bh.T) / 2 + 1e-6 * np.trace(Bh) / k * np.eye(k)
    try:
        ritz = scipy.linalg.eigh(Hh, Bh, eigvals_only=True)
    except (np.linalg.LinAlgError, ValueError):
        return None
    target = float(np.quantile(ritz, q))
    # DEGENERACY SNAP: a target inside a tie cluster of Ritz values moves to
    # the midpoint of the larger adjacent gap
    spread = float(ritz[-1] - ritz[0]) + 1e-300
    tol = 1e-4 * spread
    lo = int(np.searchsorted(ritz, target - tol, side="left"))
    hi = int(np.searchsorted(ritz, target + tol, side="right"))
    if hi - lo > max(3, int(0.02 * k)):
        below = float(ritz[lo] - ritz[lo - 1]) if lo > 0 else -np.inf
        above = float(ritz[hi] - ritz[hi - 1]) if hi < k else -np.inf
        if above >= below and np.isfinite(above):
            return float(0.5 * (ritz[hi - 1] + ritz[hi]))
        if np.isfinite(below):
            return float(0.5 * (ritz[lo - 1] + ritz[lo]))
        # the tie spans the whole sketch: a (near-)multiple of identity;
        # the caller's forced half-split handles it exactly
    return target


def _projector_rank(S, dtype, rows=WHOLE):
    """P_lo = (I - sign)/2 in ``dtype``, computed in place over S (the sign
    iterate is dead past the projector); returns (P_lo, trace estimate of
    its rank)."""
    P = S.neg_()
    rows.diag(P).add_(1.0)
    P.mul_(0.5)
    return P.to(dtype), rows.sum(rows.diag(P))


def _project_out(V, Y, rows=WHOLE):
    return Y - torch.matmul(V, rows.gram(V, Y))


def _qr_q(Y, rows=WHOLE):
    """Householder-QR orthonormalization: always returns exactly
    orthonormal columns, even for rank-deficient Y (deficient directions
    become arbitrary orthonormal completions -- harmless inside a
    (near-)degenerate eigenspace, and the coupling check catches the
    harmful case).  Over row slabs: Householder TSQR."""
    return rows.qr_q(Y)


def _cholqr2(Y, rows=WHOLE):
    """CholeskyQR2: two CholeskyQR passes give machine-orthonormal columns
    for moderately conditioned Y, as GEMMs plus a (k, k) Cholesky and a
    triangular solve.  Only the first pass shifts the Gram by
    eps * trace(G), which keeps an ill-conditioned Y's Cholesky from
    failing; a shift in the second pass too (the JAX module) leaves
    |Q'Q - I| near k * eps.  A rank-deficient Y yields NaN columns, as the
    JAX package's Cholesky does: ``cholesky_ex`` reports the failure in
    ``info`` (no host sync) and the factor is then set to NaN, so
    :func:`_ortho_cols`'s one finiteness check catches it.  Over row
    slabs the Gram is all-reduced and the Cholesky runs on the group's
    first rank."""
    eps = torch.finfo(Y.dtype).eps
    for shift in (True, False):
        G = rows.gram(Y, Y)
        if shift:
            G.diagonal().add_(eps * torch.trace(G))
        L, info = rows.small(torch.linalg.cholesky_ex, G)
        L = L.masked_fill(info.ne(0), float("nan"))
        # Y <- Y L^-T
        Y = torch.linalg.solve_triangular(L.T, Y, upper=True, left=False)
    return Y


def _panel_step_cqr(Qbuf, Yj, j: int, rows=WHOLE) -> None:
    """BCGS2 panel step with CholeskyQR2 panel factorization (see
    :func:`_cholqr2`; :func:`_panel_step` is the Householder variant for
    rank-deficient panels): writes the panel into ``Qbuf[:, j:]``."""
    Q = Qbuf[:, :j]
    for _ in range(2):
        Yj = _project_out(Q, Yj, rows)
    Qbuf[:, j:j + Yj.shape[1]] = _cholqr2(Yj, rows)


def _panel_step(Qbuf, Yj, j: int, rows=WHOLE) -> None:
    """One panel of blocked BCGS2 with Householder QR: project the (n,
    panel) slab Yj against the already-filled columns of Qbuf and
    orthonormalize it, twice, and write it at column j.  The second pass
    works on the NORMALIZED panel: when the slab lies (nearly) inside the
    earlier panels' span -- a rank-deficient block, the case this route
    exists for -- its remainder is roundoff, which the first QR scales up
    together with its components along the earlier panels.  (The JAX
    module projects twice and orthonormalizes once, which leaves such a
    panel far from orthogonal to the earlier ones.)"""
    Q = Qbuf[:, :j]
    for _ in range(2):
        Yj = _qr_q(_project_out(Q, Yj, rows), rows)
    Qbuf[:, j:j + Yj.shape[1]] = Yj


def _panel_qr(Y, panel: int = _PANEL, cholqr: bool = True, rows=WHOLE):
    """Orthonormalize the columns of a tall (n, k) block with GEMMs plus
    per-panel factorizations (blocked BCGS2).  ``cholqr=True`` uses the
    CholeskyQR2 panel (GEMM-dominated); False is the rank-robust
    Householder route."""
    Qbuf = torch.empty_like(Y)
    step = _panel_step_cqr if cholqr else _panel_step
    for j in range(0, Y.shape[1], panel):
        step(Qbuf, Y[:, j:j + panel], j, rows)
    return Qbuf


def _householder_cols(Y, rows=WHOLE):
    """The Householder route: exactly orthonormal columns for any Y, rank
    deficiency included (panels above _PANEL_QR_MAX_DIRECT columns)."""
    if Y.shape[1] <= _PANEL_QR_MAX_DIRECT:
        return _qr_q(Y, rows)
    return _panel_qr(Y, cholqr=False, rows=rows)


def _ortho_cols(Y, rows=WHOLE):
    """Orthonormalization dispatch.

    Fast path: CholeskyQR2 (whole-block when narrow, BCGS2 panels when
    wide).  A rank-deficient block makes CholQR emit NaN columns; the ONE
    host check per call catches that and reruns through the Householder
    route, which completes deficient directions with arbitrary orthonormal
    ones (harmless inside a (near-)degenerate eigenspace -- the coupling
    gate downstream catches the harmful case)."""
    k = Y.shape[1]
    Q = (_cholqr2(Y, rows) if k <= _PANEL
         else _panel_qr(Y, cholqr=True, rows=rows))
    if rows.all_finite(Q[:1].sum() + Q[-1:].sum()):
        return Q
    return _householder_cols(Y, rows)


def _orthonormal_range(P, k: int, seed: int, refine: int = 1, rows=WHOLE):
    """Orthonormal (n, k) basis of the rank-k range of projector P:
    randomized range finding with _RANGE_OVERSAMPLE spare columns
    (subspace iteration sharpens the basis), then a Rayleigh-Ritz step on
    P that keeps the k directions of largest P.  The Gaussian block is
    drawn on P's device.

    Eigenvalues within ~1e-4 of sigma leave the sign unconverged, so P
    holds values between 0 and 1 for their directions.  The JAX module
    takes exactly k columns: such a direction then enters the basis in
    part, and the complement -- the other side of the split -- receives
    the low directions it displaced, a mixture of widely spread
    eigenvalues whose coupling entries are too diffuse for the coupling
    gate.  With spare columns each such direction lies in the sketch
    whole, and the Rayleigh-Ritz step keeps or drops it whole.  The spare
    columns mostly span directions where P is ~0, so the sketch is
    numerically rank-deficient: it is orthonormalized by the Householder
    route, which CholeskyQR would orthonormalize only loosely.  Over row
    slabs the Gaussian block is drawn whole on every rank (the values one
    process draws) and P's products are ring products."""
    n = P.shape[1]
    m = min(n, k + _RANGE_OVERSAMPLE)
    Q = _householder_cols(torch.matmul(P, _randn((n, m), P, seed)), rows)
    for _ in range(refine):
        Q = _householder_cols(rows.mm(P, Q), rows)
    B = rows.gram(Q, rows.mm(P, Q))
    _, W = rows.small(torch.linalg.eigh, 0.5 * (B + B.T))
    return torch.matmul(Q, W[:, m - k:])


def _back_transform(V, Usub):
    return torch.matmul(V, Usub)


def _pair_residuals(A, U, ev, rows=WHOLE):
    """Per-eigenpair residual norms ||A u_i - ev_i u_i||_2 and Rayleigh
    quotients, from ONE full GEMM.

    The residual matrix is materialized and normed directly: the
    algebraically equivalent ||AU||^2 - 2 ev d + ev^2 cancels
    catastrophically in float32 (s ~ 1e-2 noise on an EXACT eigenbasis of
    3.5*I, falsely triggering the repair)."""
    AU = rows.mm(A, U)
    d = rows.coldot(U, AU)
    s = rows.colnorm(AU - U * ev[None, :])
    return s, d, AU


def _residual_repair(A, ev, U, verbose=False, tol_rel=2e-3, max_bad=512,
                     rounds: int = 8, rows=WHOLE):
    prev = np.inf
    for r in range(rounds):
        ev, U, fixed, s_max = _residual_repair_once(
            A, ev, U, verbose, tol_rel, max_bad, rows)
        if fixed:
            return ev, U
        if verbose:
            print(f"[eigh_dc] residual repair round {r}: "
                  f"max resid {s_max:.2e}", flush=True)
        if s_max > prev / 1.3:
            # a round that does not contract means the defect's partner
            # mass exceeds the repair span (or it is not a mixture at
            # all); further identical rounds are pure waste
            if verbose:
                print("[eigh_dc] residual repair stalled -- keeping the "
                      "best-effort basis", flush=True)
            return ev, U
        prev = s_max
    return ev, U


def _repair_span(flag: np.ndarray, C2: np.ndarray, cap: int) -> np.ndarray:
    """Sorted column indices of the repair span: every flagged column, plus
    the coupling partners that cover >= 99.5% of each flagged residual's
    mass.  When they overflow ``cap``, the partners that carry the largest
    shares of the flagged residuals' masses are kept.  (The JAX module cut
    the sorted union at ``cap`` by column index, which can drop the flagged
    columns themselves.)"""
    share = C2 / (C2.sum(0, keepdims=True) + 1e-300)
    partners = set()
    for i in range(len(flag)):
        order_i = np.argsort(-share[:, i])
        k_need = int(np.searchsorted(np.cumsum(share[order_i, i]),
                                     0.995)) + 1
        partners.update(order_i[:k_need].tolist())
    part = np.fromiter(partners - set(flag.tolist()), dtype=np.int64)
    room = max(cap - len(flag), 0)
    if len(part) > room:
        part = part[np.argsort(-share[part, :].sum(1), kind="stable")[:room]]
    return np.sort(np.concatenate([flag.astype(np.int64), part]))


def _residual_repair_once(A, ev, U, verbose=False, tol_rel=2e-3,
                          max_bad=512, rows=WHOLE):
    """Validate every eigenpair and repair mixed directions.

    The D&C can very occasionally assign a direction that mixes two true
    eigenspaces while every split-level coupling check stays clean (the
    mixture's pieces live inside ONE side's span).  Mixtures are invisible
    to coupling but LOUD in the per-pair residual ||A u - ev u||; and they
    come in closed sets, so re-diagonalizing the Rayleigh block of the
    flagged columns and their coupling partners repairs them within their
    joint span.  Cost: one n^3 GEMM for the residual sweep (the certificate
    every call carries) plus a small eigh when something is wrong."""
    s, d, AU = _pair_residuals(A, U, ev, rows)
    scale = float(ev.abs().amax()) + 1e-30
    s_np = s.cpu().numpy()
    s_max = float(s_np.max())
    if s_max <= tol_rel * scale:
        return ev, U, True, s_max
    # flag the clearly-elevated residuals, then pull in each flagged
    # column's strongest COUPLING PARTNERS: the residual r_i = A u_i -
    # ev_i u_i lies in span(U) with coefficient c_j = (U' A u_i)_j on
    # column j (j != i), read off one (n, k) GEMM against AU
    flag = np.where(s_np > max(tol_rel * scale, 0.4 * s_max))[0]
    flag = flag[np.argsort(-s_np[flag])][:max_bad // 8]
    fl = torch.as_tensor(flag, device=U.device)
    C = rows.gram(U, AU[:, fl]).cpu().numpy().astype(np.float64)
    C[flag, np.arange(len(flag))] = 0.0  # self rows carry ev, not coupling
    C2 = C * C
    # few flagged columns can afford a wide span: a defect smeared across a
    # continuous bulk needs many partners
    cap = max_bad if len(flag) > 4 else 2048
    sel = _repair_span(flag, C2, cap)
    cov = float(C2[sel, :].sum() / (C2.sum() + 1e-300))
    if cov < 0.5:
        # the residual mass is spread (near-)uniformly over the basis --
        # not a block mixture an in-span re-diagonalization can fix
        if verbose:
            print(f"[eigh_dc] repair span {len(sel)} covers only "
                  f"{cov:.3f} of the residual mass -- not a repairable "
                  f"mixture (max resid {s_max:.2e})", flush=True)
        return ev, U, True, s_max
    if verbose:
        print(f"[eigh_dc] repair span {len(sel)} covers {cov:.3f} of the "
              f"flagged residual mass", flush=True)
    idx = torch.as_tensor(sel, device=U.device)
    Wb = U[:, idx]
    B = rows.gram(Wb, AU[:, idx])
    del AU
    B = 0.5 * (B + B.T)
    eb, Q = rows.small(_eigh_small, B)
    U = U.clone()
    ev = ev.clone()
    U[:, idx] = torch.matmul(Wb, Q)
    ev[idx] = eb
    if verbose:
        print(f"[eigh_dc] residual sweep: repaired {len(flag)} mixed "
              f"direction(s) in a {len(sel)}-dim span "
              f"(max resid {s_max:.2e})", flush=True)
    order = torch.argsort(ev)
    return ev[order], U[:, order], False, s_max


def _eigh_small(A) -> Tuple[torch.Tensor, torch.Tensor]:
    """A leaf: ``torch.linalg.eigh`` (cuSOLVER on the card) at the block's
    own size."""
    return torch.linalg.eigh(A)


def eigh_dc(
    A,
    max_block: int = DIRECT_EIGH_MAX,
    seed: int = 0,
    _depth: int = 0,
    _scale0: Optional[float] = None,
    group: Optional[SlabGroup] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full symmetric eigendecomposition (ascending), any size, on A's
    device.

    ``A``: a symmetric (n, n) tensor (or array).  ``max_block``: largest
    subproblem handed to the built-in eigh.  ``_scale0``: the ROOT matrix
    magnitude, threaded through the recursion -- the coupling gate measures
    against it, because the float32 noise floor of the split is set by the
    original matrix, not the (smaller) deep blocks.
    Returns (ev (n,), U (n, n)) on A's device, in A's dtype.  Raises
    RuntimeError when a split cannot be made to the coupling gate.

    ``group``: a :class:`~pygemma_tpu_torch.parallel.slabs.SlabGroup` of
    more than one rank, every one of which calls with its row slab of A
    (``slabs.bounds``; (rows, n)).  The n-sized products then run on the
    slabs (:class:`~pygemma_tpu_torch.parallel.slabs.Slabs`), a split's
    two children run at once on the two halves of the group, a one-rank
    child runs this function on its whole block, and every rank returns
    the same (ev, U) bytes.  The draws, and so the splits, are those of one
    process.
    """
    t_start = time.time()
    if _depth == 0:
        check_matmul_precision()  # the sign steps need full float32
    A = torch.as_tensor(A)
    n = A.shape[1]
    rows = (WHOLE if group is None or group.size == 1
            else Slabs(group, n, A.device))
    # one rank of a group prints its lines
    verbose = (os.environ.get("PYGEMMA_TPU_DC_VERBOSE", "") == "1"
               and rows.leader)
    if n <= max_block:
        out = rows.leaf(A, _eigh_small)
        if verbose:
            float(out[0][0])  # wait for the device before the clock
            print(f"[eigh_dc] leaf n={n} {time.time()-t_start:.1f}s",
                  flush=True)
        return out
    if _depth > 8:
        raise RuntimeError("eigh_dc: spectral split failed to reduce size")

    # --- split point: Ritz-sketch estimate of a spectral quantile (the
    # diagonal is a poor stand-in on correlation-like matrices), nudged by
    # the realized rank on retries.  Balanced splits minimize depth; when
    # the block is barely over the leaf cap, shave a thin slice off the
    # spectrum's bottom instead (low density at the edge -> the sign
    # iteration converges fast, and the big side lands exactly at the cap).
    diag = rows.gather_rows(rows.diag(A)).cpu().numpy()
    if n <= int(1.3 * max_block):
        # floor the shave at ~2/k of the 512-point Ritz sample: a thinner
        # target than the quantile resolution lands sigma at/below
        # lambda_min (r_lo = 0)
        frac_target = max((n - max_block) / n, 2.0 / 512.0)
    else:
        frac_target = 0.5
    sigma = _spectral_quantile(A, frac_target, seed=seed * 31 + _depth,
                               rows=rows)
    if sigma is None or not np.isfinite(sigma):
        sigma = float(np.quantile(diag, frac_target))
    min_side = max(32, int(0.4 * min(frac_target, 1 - frac_target) * n))
    r_lo = 0
    for attempt in range(4):
        t_att = time.time()
        key = seed * 1009 + 17 * _depth + attempt
        # boost retry: a clustered spectrum can make the power-iteration
        # norm undershoot enough that the Newton-Schulz safety region
        # (|x| < sqrt(3)) is breached and the iteration blows up to NaN;
        # rescaling 4x and rerunning always lands inside
        boost = 1.0
        for _ in range(4):
            S = _shift_scale(A, sigma, key, boost, rows)
            # each step also returns the residual of its INPUT; in the
            # Newton-Schulz tail a converged input means the remaining
            # tail rows are no-ops up to roundoff -- skip them
            n_sched = 0
            for irow, (a, b, c) in enumerate(_SIGN_SCHEDULE):
                if c == 0.0:  # cubic row: 2 GEMMs instead of 3
                    S, r_in = _sign_step_ns(S, a, b, rows)
                else:
                    S, r_in = _sign_step(S, a, b, c, rows)
                n_sched += 1
                # start checking once the aggressive quintic block is done
                # (row 7): each check is one scalar read on the host
                if irow >= 7 and irow < len(_SIGN_SCHEDULE) - 1:
                    r_h = float(r_in)
                    if not np.isfinite(r_h) or r_h < 1.5e-2:
                        break
            # polish until converged (an eigenvalue close to sigma -- or a
            # boosted scale -- slows the contraction).  A degenerate block
            # (everything == sigma) never converges; its pseudo-projector
            # still splits the space, which is exact for an eigenspace.
            # STALL DETECTION: with sigma inside a dense spectral bulk the
            # unconverged mass is eigenvalues within ~1e-4 of sigma, which
            # extra rounds cannot fix at a useful rate; the coupling check
            # downstream guards correctness
            n_polish = 0
            prev_resid = np.inf
            for _ in range(10):
                S_new, r_in = _sign_step_ns(S, 1.5, -0.5, rows)
                resid = float(r_in)  # residual of S BEFORE this NS step
                S = S_new
                if not np.isfinite(resid) or resid < 3e-2:
                    break  # diverged, or converged (one NS only sharpens)
                if resid > prev_resid / 1.5:
                    break  # stalled: non-convergent near-sigma modes
                prev_resid = resid
                n_polish += 1
            if np.isfinite(float(_sign_residual(S, rows))):
                break
            if verbose:
                print(f"[eigh_dc] n={n} depth={_depth} attempt={attempt} "
                      f"NaN at boost={boost} -> rescale", flush=True)
            boost *= 4.0
        if verbose:
            print(f"[eigh_dc] n={n} depth={_depth} attempt={attempt} "
                  f"sigma={sigma:.4g} boost={boost} sched={n_sched} "
                  f"polish={n_polish} "
                  f"{time.time()-t_att:.1f}s", flush=True)
        P_lo, tr = _projector_rank(S, A.dtype, rows)
        tr_f = float(tr)
        r_lo = int(np.clip(round(tr_f), 0, n)) if np.isfinite(tr_f) else 0
        if min(r_lo, n - r_lo) >= min_side:
            break
        if frac_target != 0.5 and 0 < r_lo and (n - r_lo) <= max_block:
            break  # edge shave did its job: the big side fits a leaf
        # degenerate split (sigma off-target): nudge toward the other side
        # using Ritz (fallback: diagonal) quantiles
        q = (frac_target * 0.5 if r_lo / n > frac_target
             else frac_target + (1 - frac_target) * 0.5)
        s_new = _spectral_quantile(A, q, seed=seed * 31 + 7 * _depth + attempt,
                                   rows=rows)
        sigma = (s_new if s_new is not None and np.isfinite(s_new)
                 else float(np.quantile(diag, q)))
    if verbose:
        print(f"[eigh_dc] n={n} depth={_depth} split r_lo={r_lo} "
              f"sigma={sigma:.4g} sign+{time.time()-t_start:.1f}s",
              flush=True)
    del S  # the n^2 sign iterate: dead past the projector
    if r_lo == 0 or r_lo == n:
        # spectrum would not split by value (near-multiple of identity).
        # Splitting a (near-)degenerate eigenspace by ANY orthogonal
        # decomposition is exact, so force a half split; the recursion
        # bottoms out at the direct eigh either way.
        r_lo = n // 2
        P_lo = rows.eye_half(A)

    t_sub = time.time()
    # Range finding with a coupling-gated retry.  V_lo comes from
    # randomized range finding on the projector; V_hi is the orthonormal
    # COMPLEMENT of span(V_lo) (two projection sweeps of a fresh Gaussian
    # block + CholQR2) -- for an exact spectral projector the complement IS
    # range(P_hi), and the coupling gate still validates the split.
    # Rayleigh blocks and the coupling come from ONE stacked pencil
    # M = [V_lo V_hi]' A [V_lo V_hi].  Attempt 0 runs refine=1; a failed
    # gate retries once with refine=2 and a fresh seed.
    scale = float(rows.amax(A.abs())) + 1e-30
    if _scale0 is None:
        _scale0 = scale
    gate = max(scale, _scale0)
    coupling = np.inf
    best = None
    for rtry in range(2):
        V_lo = _orthonormal_range(
            P_lo, r_lo, seed=seed * 7919 + 13 + _depth + 1000 * rtry,
            refine=1 + rtry, rows=rows)
        Z = rows.take(_randn((n, n - r_lo), A,
                             seed * 7919 + 101 + _depth + 1000 * rtry))
        V_hi = _ortho_cols(_project_out(V_lo, Z, rows), rows)
        del Z
        V_hi = _ortho_cols(_project_out(V_lo, V_hi, rows), rows)
        U_split = torch.cat([V_lo, V_hi], dim=1)
        AV = rows.mm(A, U_split)
        # over row slabs M is this rank's rows of its child's block
        M, coupling = rows.pencil(U_split, AV, r_lo)
        del AV, U_split
        coupling = float(coupling)
        # accept below 8e-3*gate without retrying: a fresh-draw retry on a
        # marginal coupling costs a full range find and does not improve it
        # (the leakage is the projector's, not the draw's)
        if np.isfinite(coupling) and coupling <= 8e-3 * gate:
            best = (coupling, M, V_lo, V_hi)
            break
        # a non-finite best is always replaced (the JAX module kept a NaN
        # attempt 0 against a finite attempt 1, and then raised)
        if best is None or not np.isfinite(best[0]) or (
                np.isfinite(coupling) and coupling < best[0]):
            best = (coupling, M, V_lo, V_hi)
        # drop the local references NOW: holding a non-best candidate's
        # full-size pencil + bases across the next attempt (or into the
        # recursion) would hold n^2 values the leaf eigh can use
        del M, V_lo, V_hi
        if verbose:
            print(f"[eigh_dc] n={n} depth={_depth} retry range "
                  f"(coupling {coupling:.2e})", flush=True)
    coupling, M, V_lo, V_hi = best
    del best
    del P_lo
    if not np.isfinite(coupling) or coupling > 2e-2 * gate:
        raise RuntimeError(
            f"eigh_dc: subspace split left coupling {coupling:.2e} "
            f"(scale {scale:.2e}); falling back to a dense eigh is required")
    if verbose:
        print(f"[eigh_dc] n={n} depth={_depth} ranges+pencil+coupling "
              f"{coupling:.2e} {time.time()-t_sub:.1f}s", flush=True)
    # symmetrized diagonal blocks of the pencil are the Rayleigh blocks
    A_lo, A_hi = rows.blocks(M, r_lo)
    # every n^2 buffer that is dead across the recursion is freed NOW, so
    # the caching allocator can hand its memory to the leaf eigh
    del M
    if rows.tree is None:
        ev_lo, U_lo = eigh_dc(A_lo, max_block, seed + 1, _depth + 1, _scale0)
        del A_lo
        # back-transform the low block BEFORE recursing on the high one
        B_lo = _back_transform(V_lo, U_lo)
        del V_lo, U_lo
        ev_hi, U_hi = eigh_dc(A_hi, max_block, seed + 2, _depth + 1,
                              _scale0)
        del A_hi
    else:
        # the two children at once, each on its half of the group; then
        # every rank back-transforms its rows with both
        side = 0 if A_lo is not None else 1
        ev_c, U_c = eigh_dc(A_hi if side else A_lo, max_block,
                            seed + 1 + side, _depth + 1, _scale0,
                            rows.tree.children[side])
        del A_lo, A_hi
        (ev_lo, U_lo), (ev_hi, U_hi) = rows.share(ev_c, U_c)
        del ev_c, U_c
        B_lo = _back_transform(V_lo, U_lo)
        del V_lo, U_lo
    B_hi = _back_transform(V_hi, U_hi)
    del V_hi, U_hi
    U = torch.cat([B_lo, B_hi], dim=1)
    del B_lo, B_hi
    ev = torch.cat([ev_lo, ev_hi])
    # ascending across the two blocks (value split guarantees order up to
    # projector leakage; a final argsort makes it exact)
    order = torch.argsort(ev)
    ev, U = ev[order], U[:, order]
    if _depth == 0:
        # one-GEMM certificate + local repair of any mixed direction
        ev, U = _residual_repair(A, ev, U, verbose, rows=rows)
    U = rows.gather_rows(U)
    if verbose:
        print(f"[eigh_dc] n={n} depth={_depth} done "
              f"{time.time()-t_start:.1f}s", flush=True)
    return ev, U
