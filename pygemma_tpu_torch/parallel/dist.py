"""Sharded execution of the GWAS scan over a mesh of ranks.

The JAX package (``pygemma_tpu/parallel/dist.py``) runs one SPMD program:

* SNP-axis data parallelism.  Every per-SNP quantity of
  ``core/assoc.py::assoc_block`` is elementwise over the SNP axis (the only
  cross-SNP contraction is over samples, which stays local), so each device
  runs the whole block step, K1 included, on its (n, B / n_snp) columns,
  collective-free, and the table is gathered once.  Its shard_map programs
  ``sharded_assoc_fn``, ``sharded_implicit_prep_fn``,
  ``sharded_assoc_implicit_fn`` and ``sharded_rotate_fn`` exist to give
  that per-device body to XLA.  Here every rank is a process of its own, so
  the per-rank body is ``pygemma``'s own step (``rotate`` or the top-space
  prep, then ``assoc_block``) on the rank's columns, which
  ``SnpBlockStreamer(shard=)`` streams to it; ev, W and y are replicated.
* A sample-sharded eigendecomposition (``sharded_eigh_fn``: XLA's eigh with
  K split over the ``sample`` axis).  torch has no sample-sharded dense
  eigh, so ``pygemma`` computes the eigenbasis (the dense (ev, U) or the
  implicit (ev_top, U_top)) once, on rank 0, and broadcasts it with
  :func:`from_rank0`.  That is the one gap of the port's mesh path; the
  route to close it is ``core/eigh_dc.py``'s GEMMs sharded over ``sample``.

This module holds what the mesh adds around the per-rank step: values
computed once on rank 0 (the basis, the null fit) and the gather of the
table.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from . import distributed
from .mesh import is_writer, rank_device


def from_rank0(mesh, compute: Callable[[], Tuple[torch.Tensor, ...]]
               ) -> Tuple[torch.Tensor, ...]:
    """``compute()`` (a tuple of tensors) run on rank 0 only and broadcast:
    every rank returns rank 0's values on its own device."""
    parts = compute() if is_writer(mesh) else None
    n = distributed.broadcast_object(None if parts is None else len(parts))
    dev = rank_device(mesh)
    return tuple(distributed.broadcast(None if parts is None else parts[i],
                                       dev) for i in range(n))


def gather_columns(blocks: List[torch.Tensor], mesh, snp_axis: str,
                   m: int) -> np.ndarray:
    """The first ``m`` global columns of a run of SNP blocks, on the host on
    every rank.  ``blocks`` are this rank's (rows, B / n_snp) shares of
    consecutive blocks of B columns; the gather joins the shares of each
    block in ``snp`` order, so column b B + j B / n_snp + l of the result is
    column l of share j of block b: the SNP of that index."""
    local = torch.stack(blocks, dim=1)  # (rows, blocks, B / n_snp)
    full = distributed.gather_table({"x": local}, mesh, snp_axis)["x"]
    return full.reshape(full.shape[0], -1)[:, :m]
