"""One rank of a multi-card cell, inside the process ``launch.py`` started.

A cell whose ``chips`` is more than 1 runs ``pygemma(..., mesh=)`` on a mesh
of ``make_mesh(snp=, sample=)`` from the traffic's ``mesh``, one process a
card, as a user's ``torchrun --nproc-per-node <chips>`` would.  Every rank
draws the cohorts from the seed on its own card and makes every call, in the
same order.  What the harness itself exchanges between the ranks (the
inputs' checksums, the build barrier, rank 0's decision before each window
call, the readings gathered to rank 0) goes over a gloo group of its own, so
none of it touches a card or the program's NCCL group.
"""

from __future__ import annotations

import datetime
import hashlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

#: how long the harness's own collectives wait for the other ranks (a rank
#: that dies is ended by the launcher long before)
TIMEOUT = datetime.timedelta(minutes=10)
_CHUNK = 64 << 20  # bytes a hashing thread takes at a time


def _sha256(arrays) -> str:
    """One digest of the bytes of ``arrays``, hashed in chunks on a few
    threads (hashlib releases the interpreter lock)."""
    views = []
    for a in arrays:
        flat = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        views += [flat[i:i + _CHUNK] for i in range(0, flat.size, _CHUNK)]
    with ThreadPoolExecutor(max_workers=4) as pool:
        parts = list(pool.map(lambda v: hashlib.sha256(v).digest(), views))
    return hashlib.sha256(b"".join(parts)).hexdigest()


def cohort_digest(cohorts) -> str:
    """A checksum of everything the ranks were given: codes or genotypes,
    their means and sds, the kinship, Y and W."""
    return _sha256([a for co in cohorts for a in co[2:] if a is not None])


def table_digest(table: Dict[str, np.ndarray]) -> str:
    """A checksum of a call's six judged columns (``judge.COLUMNS``)."""
    from .judge import COLUMNS

    return _sha256([table[col] for col in COLUMNS])


class Group:
    """This rank's place in the run: the program's mesh and the harness's
    own collectives."""

    def __init__(self, mesh_shape: dict, chips: int, device):
        from pygemma_tpu_torch.parallel.mesh import make_mesh, rank_device

        snp, sample = mesh_shape["snp"], mesh_shape["sample"]
        if snp * sample != chips:
            raise SystemExit(f"a mesh of snp={snp} x sample={sample} does "
                             f"not fill the cell's {chips} chips")
        self.mesh = make_mesh(snp=snp, sample=sample,
                              device=torch.device(device).type)
        self.device = rank_device(self.mesh)
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self._gloo = dist.new_group(backend="gloo", timeout=TIMEOUT)

    def gather(self, obj) -> List:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self._gloo)
        return out

    def decide(self, go: bool) -> bool:
        """Rank 0's ``go`` on every rank."""
        flag = torch.tensor([int(go)])
        dist.broadcast(flag, 0, group=self._gloo)
        return bool(flag.item())

    def barrier(self) -> None:
        dist.barrier(group=self._gloo)

    def same_inputs(self, cohorts) -> None:
        """Abort unless every rank drew the same cohorts."""
        digests = self.gather(cohort_digest(cohorts))
        if len(set(digests)) != 1:
            raise SystemExit(f"the ranks drew different cohorts: {digests}")

    def build(self, cfg: dict) -> None:
        """Rank 0 builds the program's nvcc libraries that the scan loads
        (K1, and the REML kernel at the scan's and the null fit's Gram
        sizes, c + 2 and c + 1, in float32) while the others wait, so no
        two processes build into the package's ``_build/`` at once."""
        if self.rank == 0 and self.device.type == "cuda":
            from pygemma_tpu_torch.ops import gram_kernel, reml_kernel

            gram_kernel._load()
            for t in (cfg["c"] + 1, cfg["c"] + 2):
                reml_kernel._load(t, torch.float32)
        self.barrier()

    def close(self) -> None:
        """The last collective of the run: every rank waits here for rank
        0's check, then leaves the process group."""
        self.barrier()
        dist.destroy_process_group()
