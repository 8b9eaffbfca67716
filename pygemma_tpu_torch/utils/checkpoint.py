"""Checkpoint / resume for long GWAS runs.

The reference has no in-core checkpointing (SURVEY.md §5): SLURM-array tasks
and per-config CSV appends are its resume granularity.  Here a run directory
persists (a) the kinship eigendecomposition -- the expensive O(n^3) stage --
and (b) per-block association results with a SNP cursor, so a preempted scan
resumes at the last finished block.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


class RunCheckpoint:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._eig_path = os.path.join(run_dir, "eigen.npz")
        self._meta_path = os.path.join(run_dir, "meta.json")

    # --- eigendecomposition ------------------------------------------------
    def save_eigen(self, ev: np.ndarray, U: Optional[np.ndarray],
                   key: str = "") -> None:
        arrs = {"ev": np.asarray(ev), "key": np.asarray(key)}
        if U is not None:
            arrs["U"] = np.asarray(U)
        np.savez(self._eig_path, **arrs)

    def load_eigen(self, key: str = "") -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
        if not os.path.exists(self._eig_path):
            return None
        with np.load(self._eig_path, allow_pickle=False) as z:
            if str(z["key"]) != key:
                return None
            return z["ev"], (z["U"] if "U" in z.files else None)

    # --- association blocks -------------------------------------------------
    def _block_path(self, start: int) -> str:
        return os.path.join(self.run_dir, f"block_{start:012d}.npz")

    def save_block(self, start: int, cols: Dict[str, np.ndarray]) -> None:
        # np.savez appends ".npz" to bare paths; keep the tmp name explicit
        # so the atomic rename source exists.
        tmp = self._block_path(start) + ".tmp.npz"
        np.savez(tmp, **cols)
        os.replace(tmp, self._block_path(start))

    def has_block(self, start: int) -> bool:
        return os.path.exists(self._block_path(start))

    def load_block(self, start: int) -> Dict[str, np.ndarray]:
        with np.load(self._block_path(start)) as z:
            return {k: z[k] for k in z.files}

    def completed_blocks(self) -> List[int]:
        import re

        out = []
        for f in os.listdir(self.run_dir):
            m = re.fullmatch(r"block_(\d{12})\.npz", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def clean_stale(self) -> None:
        """Remove interrupted atomic-write temp files (crash between
        np.savez and os.replace)."""
        for f in os.listdir(self.run_dir):
            if f.endswith(".tmp.npz"):
                try:
                    os.remove(os.path.join(self.run_dir, f))
                except OSError:
                    pass

    # --- metadata ----------------------------------------------------------
    def save_meta(self, meta: dict) -> None:
        with open(self._meta_path, "w") as f:
            json.dump(meta, f)

    def load_meta(self) -> Optional[dict]:
        if not os.path.exists(self._meta_path):
            return None
        with open(self._meta_path) as f:
            return json.load(f)
