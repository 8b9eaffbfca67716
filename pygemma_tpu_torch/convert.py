"""State carried across from the JAX package.

This system has no weights.  The state a run carries is its configuration,
the kinship eigendecomposition and the per-phenotype null fit, and its
inputs may be the JAX package's streamed genotype matrices and low-rank
kinship.  These functions take each in the form the JAX package holds it
(plain Python and NumPy fields, so neither package imports the other).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import GwasConfig
from .core.assoc import NullFit
from .core.lowrank import ImplicitBasis, LowRankKinship
from .io.packed import PackedMatrix
from .io.quantized import QuantizedMatrix


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


def is_jax_object(obj) -> bool:
    """Whether ``obj`` is an instance of a class of the JAX package."""
    return type(obj).__module__.split(".")[0] == "pygemma_tpu"


def packed_matrix_from_jax(X) -> PackedMatrix:
    """A ``pygemma_tpu.io.packed.PackedMatrix`` -> the port's, sharing its
    packed bytes (no copy).  Its file identity carries over; the port's
    cache token adds a digest of the affine."""
    out = PackedMatrix(X.data, X.n, X.mu, X.sd, X.coding)
    out.source = X.cache_token
    return out


def quantized_matrix_from_jax(X) -> QuantizedMatrix:
    """A ``pygemma_tpu.io.quantized.QuantizedMatrix`` -> the port's,
    sharing its int8 codes (no copy)."""
    return QuantizedMatrix(X.data, X.mu, X.sd, X.missing_code)


def lowrank_kinship_from_jax(K) -> LowRankKinship:
    """A ``pygemma_tpu.core.lowrank.LowRankKinship`` -> the port's; a
    packed or int8 source is converted too, an ndarray is shared."""
    G = from_jax(K.G) if is_jax_object(K.G) else K.G
    return LowRankKinship(G, scale=K.scale, eps=K.eps, center=K.center)


def implicit_basis_from_numpy(ev_top, U_top, eps: float, n: int,
                              device="cuda", dtype=np.float32
                              ) -> ImplicitBasis:
    """The fields of a ``pygemma_tpu.core.lowrank.ImplicitBasis`` (ev_top
    (p_k,), U_top (n, p_k), eps, n) -> the port's, on ``device``."""
    ev_t, U_t = eigen_from_numpy(ev_top, U_top, device=device, dtype=dtype)
    if U_t.shape != (n, ev_t.shape[0]):
        raise ValueError(f"U_top is {tuple(U_t.shape)}, expected "
                         f"({n}, {ev_t.shape[0]})")
    return ImplicitBasis(ev_t, U_t, float(eps), int(n))


_FROM_JAX = {
    "PackedMatrix": packed_matrix_from_jax,
    "QuantizedMatrix": quantized_matrix_from_jax,
    "LowRankKinship": lowrank_kinship_from_jax,
}


def from_jax(obj, device="cuda"):
    """An input of the JAX package -> the port's counterpart:
    ``PackedMatrix``, ``QuantizedMatrix``, ``LowRankKinship`` or (on
    ``device``) ``ImplicitBasis``."""
    kind = type(obj).__name__
    if kind == "ImplicitBasis":
        # copies: a JAX array's host view is read-only
        return implicit_basis_from_numpy(np.array(obj.ev_top),
                                         np.array(obj.U_top), obj.eps,
                                         obj.n, device=device)
    if kind not in _FROM_JAX:
        raise TypeError(f"no port counterpart for {type(obj).__module__}."
                        f"{kind}")
    return _FROM_JAX[kind](obj)
