"""State carried across from the JAX package.

This system has no weights.  The state a run carries is its configuration,
the kinship eigendecomposition and the per-phenotype null fit; these
functions take each in the form the JAX package writes it (plain Python and
NumPy values, so neither package imports the other).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import GwasConfig
from .core.assoc import NullFit


def config_from_fields(fields: dict) -> GwasConfig:
    """``dataclasses.asdict`` of a ``pygemma_tpu.config.GwasConfig`` -> the
    port's config.  Unknown fields raise; sequences become tuples."""
    known = {f.name for f in dataclasses.fields(GwasConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown GwasConfig fields: {sorted(unknown)}")
    return GwasConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in fields.items()})


def eigen_from_numpy(ev, U, device="cuda", dtype=None):
    """(ev (n,), U (n, n)) as ``RunCheckpoint.save_eigen`` writes them ->
    tensors on ``device``.  ``U`` may be None (an eigenvalue-only file)."""
    ev_t = torch.as_tensor(np.asarray(ev, dtype)).to(device)
    U_t = None if U is None else torch.as_tensor(np.asarray(U, dtype)).to(device)
    return ev_t, U_t


def null_fit_from_numpy(arr3) -> NullFit:
    """The (lambda_reml, lambda_ml, loglik_ml) stack of the JAX package's
    null fit -> :class:`NullFit` of 0-d tensors."""
    t = torch.as_tensor(np.array(arr3))
    if t.shape != (3,):
        raise ValueError(f"expected a (3,) null-fit stack, got {tuple(t.shape)}")
    return NullFit(t[0], t[1], t[2])
