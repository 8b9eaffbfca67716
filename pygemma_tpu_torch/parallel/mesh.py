"""The rank layout of a multi-GPU run and the helpers ``pygemma`` needs.

The JAX package builds a ``jax.sharding.Mesh`` over devices
(``pygemma_tpu/parallel/mesh.py``); here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of shape (sample, snp) over
the ranks of the default process group, one process per rank.  The scan is
SNP-parallel: the ranks along the ``snp`` axis take their share of each SNP
block's columns; ranks that share a ``snp`` coordinate (a ``sample`` axis
longer than 1) compute the same columns, as the JAX program, whose scan
replicates over that axis, does.  The dense eigendecomposition splits over
those ranks instead: the ``sample`` ranks at ``snp`` coordinate 0 each
hold a row slab of K (``dist.sharded_eigh_fn``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from . import distributed


def make_mesh(snp: Optional[int] = None, sample: int = 1, device="cuda",
              snp_axis: str = "snp", sample_axis: str = "sample"
              ) -> DeviceMesh:
    """A (sample, snp) mesh over the world's ranks; ``snp=None`` takes every
    rank left after ``sample``.  Without a process group it starts one
    (:func:`distributed.initialize`: from the launcher's environment, or a
    world of this one process), on ``device``'s type; in a group started
    elsewhere the caller has set each rank's current card."""
    if dist.is_initialized():
        resolve_device(device)
    else:
        distributed.initialize(device=device)
    world = dist.get_world_size()
    if snp is None:
        snp = world // sample
    if snp < 1 or sample < 1 or snp * sample != world:
        raise ValueError(f"a mesh of sample={sample} x snp={snp} does not "
                         f"cover the world's {world} ranks")
    dev_type = torch.device(device).type
    ranks = torch.arange(world, dtype=torch.int).reshape(sample, snp)
    return DeviceMesh(dev_type, ranks, mesh_dim_names=(sample_axis, snp_axis))


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's compute device: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis(mesh: DeviceMesh, name: str) -> int:
    return mesh.mesh_dim_names.index(name)


def axis_shard(mesh: DeviceMesh, axis: str) -> Tuple[int, int]:
    """(this rank's coordinate on ``axis``, the axis' length)."""
    ax = _axis(mesh, axis)
    return mesh.get_coordinate()[ax], mesh.mesh.shape[ax]


def axis_ranks(mesh: DeviceMesh, axis: str) -> List[int]:
    """The ranks at coordinate 0 of every other axis, in ``axis`` order: on
    ``snp``, one holder of each share of the columns; on ``sample``, the
    ranks that split the eigendecomposition."""
    grid = np.moveaxis(mesh.mesh.numpy(), _axis(mesh, axis), -1)
    return grid.reshape(-1, grid.shape[-1])[0].tolist()


def local_columns(start: int, stop: int, block: int,
                  shard: Tuple[int, int]) -> Tuple[int, int]:
    """The columns [lo, hi) of block [start, stop) (``block`` wide before
    the tail is cut) that ``shard`` = (index, count) takes: an equal share
    ``block / count`` wide, cut at ``stop`` (empty past it)."""
    index, count = shard
    width = block // count
    lo = min(start + index * width, stop)
    return lo, min(lo + width, stop)


def is_writer(mesh: Optional[DeviceMesh]) -> bool:
    """Whether this rank writes the run's files (rank 0; always true without
    a mesh)."""
    return mesh is None or dist.get_rank() == 0


def put_replicated(x, mesh: DeviceMesh) -> torch.Tensor:
    """Rank 0's ``x`` (a host array or a tensor) on every rank's device: a
    broadcast from rank 0, so every rank holds the same values whatever the
    others passed (they may pass None)."""
    t = torch.as_tensor(x) if dist.get_rank() == 0 else None
    return distributed.broadcast(t, rank_device(mesh))
