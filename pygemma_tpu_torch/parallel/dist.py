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
  K split over the ``sample`` axis).  torch has no distributed dense eigh,
  so :func:`sharded_eigh_fn` runs ``core/eigh_dc.py`` with its n-sized
  products on row slabs of K over the ``sample`` ranks
  (``parallel/slabs.py``), and broadcasts the result along ``snp``.
  ``pygemma`` takes it for a dense K when the ``sample`` axis is longer
  than 1 and ``eigh_backend`` is not ``"host"``; the implicit top basis,
  the low-rank basis and a one-long ``sample`` axis keep the basis computed
  on rank 0 and broadcast with :func:`from_rank0`, as the JAX package
  computes those on one device.

This module holds what the mesh adds around the per-rank step: values
computed once on rank 0 (the basis, the null fit), the sample-sharded
eigendecomposition and the gather of the table.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ..core import eigen
from . import distributed
from .mesh import axis_ranks, axis_shard, rank_device
from .slabs import SlabGroup, bounds


def from_rank0(mesh, compute: Callable[[], Tuple[torch.Tensor, ...]]
               ) -> Tuple[torch.Tensor, ...]:
    """``compute()`` (a tuple of tensors) run on rank 0 only and broadcast:
    every rank returns rank 0's values on its own device."""
    return distributed.from_src(compute, rank_device(mesh))


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


def sharded_eigh_fn(mesh, cfg) -> Callable[[np.ndarray],
                                           Tuple[torch.Tensor, torch.Tensor]]:
    """K -> (ev, U), K's rows split over the mesh's ``sample`` ranks: the
    counterpart of the JAX package's ``sharded_eigh_fn``.

    Every rank of the mesh calls the returned function with the same K (a
    host array; a read-only memory map will do).  The ranks at ``snp``
    coordinate 0 each copy their row slab of K (``slabs.bounds``) to their
    device -- nothing broadcasts K -- and run ``eigh_dc`` on the slabs; the
    ``snp`` axis then broadcasts the result, so every rank of the mesh
    returns the same bytes.  ev is clamped at 0, as
    ``core.eigen.eigendecompose`` clamps it.  A split that fails raises
    eigh_dc's RuntimeError on every rank.

    Building it is collective: every rank of the world calls this in the
    same order (the children's process groups are made here)."""
    ranks = axis_ranks(mesh, cfg.sample_axis)  # the sample ranks at snp 0
    sample_at, _ = axis_shard(mesh, cfg.sample_axis)
    snp_at, n_snp = axis_shard(mesh, cfg.snp_axis)
    tree = SlabGroup(ranks)
    dev = rank_device(mesh)

    def eigh(K) -> Tuple[torch.Tensor, torch.Tensor]:
        n = K.shape[0]
        ev = U = error = None
        if snp_at == 0:
            lo, hi = bounds(n, tree.size)[tree.index]
            slab = torch.from_numpy(np.array(K[lo:hi])).to(dev)
            try:
                ev, U = eigen.eigh_dc(slab, group=tree)
            except RuntimeError as e:
                error = (f"{e} (the sample-sharded eigendecomposition; "
                         'eigh_backend="host" decomposes K on rank 0 instead)')
            else:
                ev = torch.clamp_min(ev, 0.0)
            del slab
        if n_snp > 1:
            # along snp, from this row's rank at snp coordinate 0
            group, src = mesh.get_group(cfg.snp_axis), ranks[sample_at]
            error = distributed.broadcast_object(error, src, group)
            if error is None:
                ev, U = (distributed.broadcast(t, dev, src, group)
                         for t in (ev, U))
        if error is not None:
            raise RuntimeError(error)
        return ev, U

    return eigh
