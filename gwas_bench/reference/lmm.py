"""Plain reference of the LMM scan: GEMMA's REML Wald test, in float64.

Written from the mathematics of ``tests/oracle.py`` (itself the reference
pyGEMMA's semantics, SURVEY.md §3), with the n x n projection matrices
replaced by their (c + 2) x (c + 2) weighted Grams so that it runs at
biobank n.  It imports nothing of the program and takes nothing the
program made: the kinship's eigendecomposition is worked out again here
from the same K, or from the same genotype codes for a low-rank GRM.

In K's eigenbasis H = lambda K + I is diagonal, h_i = lambda ev_i + 1, and
with D = diag(1 / h) and Z = [W, x, y] every quantity of the REML
likelihood is a function of G_k = Z' D^k Z for k = 1, 2, 3.  A low-rank
kinship K = s Gc Gc' + eps I has p_k explicit eigen-directions and an
(n - p_k)-dimensional complement of eigenvalue eps; its part of G_k is
(Z'Z - C'C) / (lambda eps + 1)^k with C the top-space coordinates of Z.

``precision`` selects the arithmetic: "float64" is the reference; "tf32"
(float32 with every matrix product's operands rounded to TF32's 10-bit
mantissa, as the tensor cores take them) is the control that the
comparison has to refuse.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from scipy import stats

MIN_VAL = 1e-35  # the reference's clamp on quadratic forms
LOG10_LO, LOG10_HI = -5.0, 5.0  # lambda's decade range
BISECT_STEPS = 56  # a decade halved 56 times is below float64's resolution


def dtype_of(precision: str) -> torch.dtype:
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits, nearest even)."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """A matrix product in ``precision`` (batched when 3-D)."""
    if precision == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    return torch.matmul(a, b)


class Eigenspace(NamedTuple):
    """K's eigenvalues on its explicit directions and how to reach them.

    ``ev`` (m,): explicit eigenvalues; ``n_comp`` complement directions
    share the eigenvalue ``eps`` (0 for a full basis).  ``rotate(Z)`` gives
    the (m, k) coordinates of Z's columns."""

    ev: torch.Tensor
    n: int
    n_comp: int
    eps: float
    basis: torch.Tensor  # U (n, m), or Gc (n, p_k) for a low-rank K
    scale: Optional[torch.Tensor]  # V * sqrt(s / a) for a low-rank K
    precision: str

    def rotate(self, Z: torch.Tensor) -> torch.Tensor:
        Z = Z.to(self.basis.dtype)
        if self.scale is None:
            return mm(self.basis.T, Z, self.precision)
        return mm(self.scale.T, mm(self.basis.T, Z, self.precision),
                  self.precision)


def dense_eigenspace(K: torch.Tensor, precision: str) -> Eigenspace:
    """Full eigendecomposition of a dense K, eigenvalues clamped at 0
    (reference lmm/lmm.py:157)."""
    ev, U = torch.linalg.eigh(K.to(dtype_of(precision)))
    return Eigenspace(torch.clamp_min(ev, 0.0), K.shape[0], 0, 0.0, U, None,
                      precision)


def lowrank_eigenspace(G: torch.Tensor, eps: float, precision: str,
                       rank_rtol: float = 1e-10) -> Eigenspace:
    """K = Gc Gc' / p_k + eps I for the (n, p_k) standardized genotypes G,
    columns re-centred: the eigenpairs of A = Gc'Gc / p_k give K's top
    space (u = Gc v sqrt(1 / (p_k a)), eigenvalue a + eps); every other
    direction has eigenvalue eps.  Gram directions with a below
    ``rank_rtol`` of the largest are left to the complement, where their
    eigenvalue eps already is."""
    n, pk = G.shape
    Gc = G.to(dtype_of(precision))
    Gc = Gc - Gc.mean(0, keepdim=True)
    s = 1.0 / pk
    a, V = torch.linalg.eigh(mm(Gc.T, Gc, precision) * s)
    keep = a > rank_rtol * a.max()
    a, V = a[keep], V[:, keep]
    return Eigenspace(a + eps, n, n - int(a.numel()), float(eps), Gc,
                      V * torch.sqrt(s / a)[None, :], precision)


def _pairs(k: int):
    iu = torch.triu_indices(k, k)
    return iu[0], iu[1]


class Rows(NamedTuple):
    """The scan's answers to be worked out: row r tests SNP column x_r
    against phenotype y_r, with covariates W shared by all rows."""

    P: torch.Tensor  # (R, m, T) products of the coordinates of [W, x, y]
    comp: torch.Tensor  # (R, T) complement part of Z'Z (0 for a full basis)
    c: int


def rows(space: Eigenspace, W: torch.Tensor, X: torch.Tensor,
         Y: torch.Tensor) -> Rows:
    """Rows for SNP columns X (n, R) against phenotypes Y (n, R)."""
    dt = space.basis.dtype
    W, X, Y = (t.to(dt) for t in (W, X, Y))
    R, c = X.shape[1], W.shape[1]
    CW, CX, CY = (space.rotate(t) for t in (W, X, Y))
    # Z_r = [W, x_r, y_r] in coordinates: (R, m, c + 2)
    C = torch.cat([CW[None].expand(R, -1, -1), CX.T[:, :, None],
                   CY.T[:, :, None]], dim=2)
    i, j = _pairs(c + 2)
    P = C[:, :, i] * C[:, :, j]
    if space.n_comp:
        Z = torch.cat([W[None].expand(R, -1, -1), X.T[:, :, None],
                       Y.T[:, :, None]], dim=2)
        comp = (Z[:, :, i] * Z[:, :, j]).sum(1) - P.sum(1)
    else:
        comp = torch.zeros(R, i.numel(), dtype=dt, device=P.device)
    return Rows(P, comp, c)


def _grams(space: Eigenspace, rw: Rows, lam: torch.Tensor):
    """G_1, G_2 (R, L, k, k), tr D and sum log h at lam (R, L)."""
    k = rw.c + 2
    i, j = _pairs(k)
    h = lam[..., None] * space.ev + 1.0  # (R, L, m)
    w = 1.0 / h
    hc = lam * space.eps + 1.0
    out = []
    for power in (1, 2):
        flat = mm(w ** power, rw.P, space.precision)  # (R, L, T)
        if space.n_comp:
            flat = flat + rw.comp[:, None, :] / hc[..., None] ** power
        G = flat.new_zeros(flat.shape[:2] + (k, k))
        G[..., i, j] = flat
        G[..., j, i] = flat
        out.append(G)
    trace = w.sum(-1) + space.n_comp / hc
    logh = torch.log(h).sum(-1) + space.n_comp * torch.log(hc)
    return out, trace, logh


def _tr(A: torch.Tensor) -> torch.Tensor:
    return A.diagonal(dim1=-2, dim2=-1).sum(-1)


def _quantities(space: Eigenspace, rw: Rows, lam: torch.Tensor):
    """REML pieces for the design V = [W, x] and response y at lam (R, L):
    yPy, yPPy, trP, log det(V'DV) and sum log h (oracle.py's ``proj``
    forms, through the Grams)."""
    (G1, G2), t1, logh = _grams(space, rw, lam)
    q = rw.c + 1
    M = torch.linalg.inv(G1[..., :q, :q])
    a = (M @ G1[..., :q, q:]).squeeze(-1)  # P y = D (y - V a)

    def rDr(G):  # r'D^k r, r = y - V a
        quad = a[..., None, :] @ G[..., :q, :q] @ a[..., :, None]
        return (G[..., q, q] - 2.0 * (a * G[..., :q, q]).sum(-1)
                + quad[..., 0, 0])

    yPy = rDr(G1)
    yPPy = rDr(G2)
    trP = t1 - _tr(M @ G2[..., :q, :q])
    logdet = torch.linalg.slogdet(G1[..., :q, :q])[1]
    return yPy, yPPy, trP, logdet, logh, G1


def d1_restricted(space, rw, lam):
    """d loglik_R / d lambda (oracle.py ``d1_restricted``)."""
    yPy, yPPy, trP, _, _, _ = _quantities(space, rw, lam)
    nq = space.n - (rw.c + 1)
    yPy = torch.clamp_min(yPy, MIN_VAL)
    yPPy = torch.clamp_min(yPPy, 0.0)
    return -0.5 * (nq - trP) / lam + 0.5 * nq * ((yPy - yPPy) / lam) / yPy


def loglik_restricted(space, rw, lam):
    """loglik_R with the logdet(V'V) term left out, as the reference's
    precompute path does (oracle.py ``loglik_restricted``)."""
    yPy, _, _, logdet, logh, _ = _quantities(space, rw, lam)
    nq = space.n - (rw.c + 1)
    res = 0.5 * nq * math.log(0.5 * nq / math.pi) - 0.5 * nq
    return (res - 0.5 * logh - 0.5 * logdet
            - 0.5 * nq * torch.log(torch.clamp_min(yPy, MIN_VAL)))


def reml_lambda(space: Eigenspace, rw: Rows) -> torch.Tensor:
    """Each row's REML lambda: the decade scan of d1's sign, every bracket
    with a sign change refined to its root (bisection in log10 lambda to
    float64 resolution, where the reference uses brentq then Newton), and
    the root or end point of largest likelihood, ties to the earlier
    candidate (oracle.py ``calc_lambda``)."""
    dev, dt = rw.P.device, rw.P.dtype
    R = rw.P.shape[0]
    n_dec = int(round(LOG10_HI - LOG10_LO))
    grid = LOG10_LO + torch.arange(n_dec + 1, device=dev, dtype=dt)
    f = d1_restricted(space, rw, (10.0 ** grid).expand(R, -1).contiguous())
    lo = grid[:-1].expand(R, -1).clone()
    hi = grid[1:].expand(R, -1).clone()
    f_lo = torch.sign(f[:, :-1])
    change = f_lo * torch.sign(f[:, 1:]) < 0
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        same = torch.sign(d1_restricted(space, rw, 10.0 ** mid)) == f_lo
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid)
    roots = 10.0 ** (0.5 * (lo + hi))
    ends = torch.tensor([10.0 ** LOG10_LO, 10.0 ** LOG10_HI], device=dev,
                        dtype=dt).expand(R, -1)
    cand = torch.cat([ends, roots], dim=1)
    lik = loglik_restricted(space, rw, cand)
    lik[:, 2:] = torch.where(change, lik[:, 2:], -math.inf)
    # the reference keeps the higher end point (the low one on a tie), then
    # takes a root only on strict improvement, in increasing order
    best = torch.where(lik[:, 1] > lik[:, 0], 1, 0)
    best_lik = lik.gather(1, best[:, None])[:, 0]
    for b in range(2, cand.shape[1]):
        better = lik[:, b] > best_lik
        best = torch.where(better, b, best)
        best_lik = torch.where(better, lik[:, b], best_lik)
    return cand.gather(1, best[:, None])[:, 0]


def wald(space: Eigenspace, rw: Rows, lam: torch.Tensor) -> dict:
    """The table's Wald columns at lam (R,): beta, se_beta, tau, F_wald,
    p_wald, and loglik_R (oracle.py ``assoc_scan``)."""
    lam2 = lam[:, None].to(rw.P.dtype)
    yPy, _, _, logdet, logh, G1 = _quantities(space, rw, lam2)
    c = rw.c
    nq = space.n - (c + 1)
    # x'P_c x and x'P_c y, P_c the projection of the covariates alone
    Gw = G1[..., :c, :c]
    Wx, Wy = G1[..., :c, c:c + 1], G1[..., :c, c + 1:c + 2]
    sol_x = torch.linalg.solve(Gw, Wx)
    xPx = G1[..., c, c] - (Wx * sol_x).sum((-2, -1))
    xPy = G1[..., c, c + 1] - (Wy * sol_x).sum((-2, -1))
    xPx = torch.clamp_min(xPx, MIN_VAL)[:, 0]
    beta = xPy[:, 0] / xPx
    yPxy = torch.clamp_min(yPy, MIN_VAL)[:, 0]
    se = torch.sqrt(yPxy) / (torch.sqrt(xPx) * math.sqrt(nq))
    F = (beta / se) ** 2
    res = 0.5 * nq * math.log(0.5 * nq / math.pi) - 0.5 * nq
    loglik = (res - 0.5 * logh - 0.5 * logdet
              - 0.5 * nq * torch.log(torch.clamp_min(yPy, MIN_VAL)))[:, 0]
    out = {"beta": beta, "se_beta": se, "tau": nq / yPxy, "lambda": lam,
           "F_wald": F, "loglik": loglik}
    out = {k: v.double().cpu().numpy() for k, v in out.items()}
    out["p_wald"] = stats.f.sf(out["F_wald"], 1, nq)
    return out


def scan(space: Eigenspace, W, X, Y, block: int = 512) -> dict:
    """The reference's table for SNP columns X (n, R) against phenotypes
    Y (n, R), in blocks of rows."""
    parts = []
    for s in range(0, X.shape[1], block):
        rw = rows(space, W, X[:, s:s + block], Y[:, s:s + block])
        parts.append(wald(space, rw, reml_lambda(space, rw)))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def judge(space: Eigenspace, W, X, Y, got: dict, block: int = 512) -> dict:
    """Work out each row's answer again and hold ``got`` (the judged
    side's table columns per row) to it.  Per row: the REML likelihood's
    gap below its maximum at the judged lambda, and the gaps of every
    other column from the reference's values at that same lambda, so that
    a flat optimum does not swing them: beta (over se), se and tau
    (relative), the Wald statistic (as |z| = sqrt(F)) and its p-value (as
    log10 p, relative to |log10 p_ref| where that is over 1, so that the
    strongest hits are held to the digits they carry; the reference's p in
    float64)."""
    out = {"loglik_gap": [], "z_err": [], "se_err": [], "tau_err": [],
           "f_err": [], "p_err": [], "lambda_ref": []}
    for s in range(0, X.shape[1], block):
        rw = rows(space, W, X[:, s:s + block], Y[:, s:s + block])
        best = wald(space, rw, reml_lambda(space, rw))
        lam = torch.as_tensor(np.asarray(got["lambda"][s:s + block],
                                         np.float64), device=rw.P.device)
        at = wald(space, rw, lam)
        mine = {k: np.asarray(got[k][s:s + block], np.float64)
                for k in ("beta", "se_beta", "tau", "F_wald", "p_wald")}
        out["loglik_gap"].append(best["loglik"] - at["loglik"])
        out["z_err"].append(np.abs(mine["beta"] - at["beta"])
                            / at["se_beta"])
        out["se_err"].append(np.abs(mine["se_beta"] / at["se_beta"] - 1.0))
        out["tau_err"].append(np.abs(mine["tau"] / at["tau"] - 1.0))
        out["f_err"].append(np.abs(np.sqrt(mine["F_wald"])
                                   - np.sqrt(at["F_wald"])))
        with np.errstate(divide="ignore", invalid="ignore"):
            lp, lp_ref = np.log10(mine["p_wald"]), np.log10(at["p_wald"])
            out["p_err"].append(np.abs(lp - lp_ref)
                                / np.maximum(1.0, np.abs(lp_ref)))
        out["lambda_ref"].append(best["lambda"])
    return {k: np.concatenate(v) for k, v in out.items()}
