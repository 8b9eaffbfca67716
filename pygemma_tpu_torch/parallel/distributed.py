"""Multi-process runtime: starting the process group, and the collectives
the scan needs (replicating inputs from rank 0, gathering the table).

The reference's only inter-node mechanism is SLURM job arrays with offline
CSV concatenation (SURVEY.md §2.3).  Here a multi-GPU run is one program of
one process per rank:

    # under torchrun --nproc-per-node N, or srun with one task per card
    from pygemma_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(snp=N)          # starts the group from the environment
    df = pygemma(Y, X, W, K, mesh=mesh)

Every rank passes the same inputs and returns the identical full table.

The collective transport is NCCL when every rank of a host has a card of
its own, else gloo: NCCL refuses two ranks on one card, and gloo is the
only choice on the CPU.  Either way the compute stays on the rank's device;
under gloo a CUDA tensor is staged through the host for each collective.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

logger = logging.getLogger(__name__)

#: how long a collective may wait for the other ranks (a rank that died
#: surfaces as a timeout on the others)
TIMEOUT = datetime.timedelta(minutes=30)


def _env_int(names: Sequence[str], default: int) -> int:
    """The first of ``names`` set in the environment, as an int (SLURM's
    ``2(x3)`` task lists give their leading count)."""
    for name in names:
        val = os.environ.get(name)
        if val:
            return int(val.split("(")[0].split(",")[0])
    return default


def resolve_backend(device: torch.device, local_world_size: int) -> str:
    """``"nccl"`` when the ranks of a host each have a card of their own,
    else ``"gloo"`` (ranks sharing a card, or on the CPU)."""
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(device="cuda", world_size: Optional[int] = None,
               rank: Optional[int] = None,
               init_method: Optional[str] = None) -> torch.device:
    """Join (or start) the default process group; returns the rank's device.

    Defaults come from the launcher's environment: ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``
    (torchrun), with the SLURM names as fallbacks (``SLURM_NTASKS``,
    ``SLURM_PROCID``, ``SLURM_LOCALID``, ``SLURM_NTASKS_PER_NODE``; the JAX
    package's ``parallel/distributed.py:38-52``).  Without any of them the
    world is this one process, whose group lives in a store of its own.

    On a CUDA device the rank's current device becomes ``cuda:(local_rank %
    device_count)``, so its kernels, copies and NCCL calls go to its own
    card.  Without a card a CUDA run raises; it never moves to the CPU.
    The backend follows :func:`resolve_backend` and is logged.  Calling it
    again in a process whose group exists only sets the device.
    """
    dev = resolve_device(device)
    if world_size is None:
        world_size = _env_int(("WORLD_SIZE", "SLURM_NTASKS"), 1)
    if rank is None:
        rank = _env_int(("RANK", "SLURM_PROCID"), 0)
    local_rank = _env_int(("LOCAL_RANK", "SLURM_LOCALID"), rank)
    local_world = _env_int(("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE"),
                           world_size)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = resolve_backend(dev, local_world)
    if world_size == 1 and init_method is None \
            and "MASTER_PORT" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    else:
        if init_method is None:
            if "MASTER_PORT" not in os.environ:
                raise RuntimeError(
                    f"a world of {world_size} ranks needs MASTER_ADDR and "
                    "MASTER_PORT (or init_method) to meet")
            addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
            init_method = f"tcp://{addr}:{os.environ['MASTER_PORT']}"
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=TIMEOUT)
    logger.info("torch.distributed: rank %d of %d on %s, backend %s",
                rank, world_size, dev, backend)
    return dev


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn, world: int, port: int, args) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = ()) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes on this host, one per
    rank, with the launcher's environment set (``RANK``, ``LOCAL_RANK``,
    ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` on
    a free localhost port), so :func:`initialize` joins them into one group.
    Processes start fresh (the ``spawn`` method: safe after CUDA is
    initialised in the caller); ``fn`` and ``args`` must pickle.  Returns
    when every rank has; a rank's exception fails the call with that
    rank's traceback."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_entry, args=(fn, nprocs, _free_port(), args),
                       nprocs=nprocs, start_method="spawn")


def _staged() -> bool:
    """Whether collectives go through host tensors (gloo)."""
    return dist.get_backend() != "nccl"


def _transport(t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if _staged() else t


def broadcast(t: Optional[torch.Tensor], device: torch.device,
              src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s tensor on every rank (of ``group``; ``src`` is a
    global rank), on ``device``.  The other ranks pass None: the shape and
    dtype travel first."""
    meta = [(tuple(t.shape), t.dtype) if dist.get_rank() == src else None]
    dist.broadcast_object_list(meta, src=src, group=group)
    shape, dtype = meta[0]
    if dist.get_rank() == src:
        t = t.to(device)  # a host input too: NCCL sends device tensors
        dist.broadcast(_transport(t.contiguous()), src=src, group=group)
        return t
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if _staged() else device)
    dist.broadcast(buf, src=src, group=group)
    return buf.to(device)


def broadcast_object(obj, src: int = 0, group=None):
    """Rank ``src``'s picklable object on every rank (of ``group``)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def from_src(compute, device: torch.device, src: int = 0,
             group=None) -> tuple:
    """``compute()`` (a tuple of tensors) run on rank ``src`` only and
    broadcast: every rank (of ``group``) returns its values on ``device``."""
    parts = compute() if dist.get_rank() == src else None
    n = broadcast_object(None if parts is None else len(parts), src, group)
    return tuple(broadcast(None if parts is None else parts[i], device, src,
                           group) for i in range(n))


def all_sum(value: int) -> int:
    """The sum of an integer over the ranks (e.g. per-process counters)."""
    t = torch.tensor([value], dtype=torch.int64)
    if not _staged():
        t = t.cuda()
    dist.all_reduce(t)
    return int(t.item())


def all_true(flag: bool) -> bool:
    """Whether ``flag`` holds on every rank."""
    return all_sum(int(not flag)) == 0


def all_gather(t: torch.Tensor) -> List[np.ndarray]:
    """Every rank's tensor (all of one shape), on the host, in rank order."""
    t = _transport(t.contiguous())
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return [p.cpu().numpy() for p in parts]


def gather_table(cols: Dict[str, torch.Tensor], mesh,
                 snp_axis: str = "snp") -> Dict[str, np.ndarray]:
    """All-gather per-SNP result columns of a SNP-sharded computation.

    Each rank passes its local columns, every rank gets the full host
    table: for each name, the parts of the ranks at ``sample`` coordinate 0
    joined along the last axis in ``snp`` order (ranks that share a ``snp``
    coordinate hold the same columns; one copy is kept).  The in-program
    replacement for the reference's offline CSV concatenation
    (tests/combine_benchmarks.py:17-29)."""
    from .mesh import axis_ranks

    order = axis_ranks(mesh, snp_axis)
    out = {}
    for k, v in cols.items():
        parts = all_gather(v)
        out[k] = np.concatenate([parts[r] for r in order], axis=-1)
    return out
