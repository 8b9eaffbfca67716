"""Plain (non-mixed) linear regression scan, vectorized over SNPs.

Parity with the reference's linear-regression alternative path
(experiments/wtccc/run_pygemma.py:153-230, env LINEAR; and
experiments/1000G/run_lin_reg.py): per SNP x, OLS fit of y ~ [W, x] and the
Wald test on the x coefficient.  On the device: residualize y and X against
W once, then the per-SNP slope is a pair of reductions.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch
from scipy import stats

from .device import resolve_device


def _linreg_block(W: torch.Tensor, y: torch.Tensor, X: torch.Tensor):
    n, c = W.shape
    # residualize against W via normal equations (c is small)
    Winv = torch.linalg.inv(W.T @ W)
    y_r = y - W @ (Winv @ (W.T @ y))
    X_r = X - W @ (Winv @ (W.T @ X))
    xx = torch.sum(X_r * X_r, dim=0)
    xy = X_r.T @ y_r
    beta = xy / xx
    resid_ss = torch.sum(y_r * y_r) - beta * xy
    sigma2 = resid_ss / (n - c - 1)
    se = torch.sqrt(sigma2 / xx)
    return beta, se, beta / se


def linreg(Y, X, W=None, snps=None, device="cuda") -> pd.DataFrame:
    """OLS association scan on ``device`` -> DataFrame(beta, se_beta, t,
    p_wald), float32 like the JAX package's; p from Student's t on the
    host in float64."""
    dev = resolve_device(device)
    Y = np.asarray(Y, np.float32).reshape(-1)
    X = np.asarray(X, np.float32)
    n, p = X.shape
    W = np.ones((n, 1), np.float32) if W is None else np.asarray(W, np.float32)
    beta, se, t = (v.cpu().numpy() for v in _linreg_block(
        *(torch.as_tensor(a).to(dev) for a in (W, Y, X))))
    df = n - W.shape[1] - 1
    t_h = t.astype(np.float64)
    out = pd.DataFrame({
        "beta": beta,
        "se_beta": se,
        "t": t_h,
        "p_wald": 2.0 * stats.t.sf(np.abs(t_h), df),
    })
    if snps is not None:
        out["SNPs"] = list(snps)
    return out
