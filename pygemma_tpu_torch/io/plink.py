"""PLINK binary (.bed/.bim/.fam) fileset helpers.

.bed layout: 3 magic bytes (0x6c 0x1b 0x01 = SNP-major), then per SNP
ceil(n/4) bytes, 2 bits per sample:
    00 -> homozygous A1   01 -> missing   10 -> het   11 -> homozygous A2

The port streams a .bed's data bytes verbatim and decodes them on the
device (:meth:`pygemma_tpu_torch.io.packed.PackedMatrix.open_bed`); this
module holds the text-sidecar reader that needs and the writer tests and
fixtures use.  The host-side float reader (``read_bed``) and its native C++
decoder are not ported.
"""

from __future__ import annotations

from typing import List

import numpy as np

_MAGIC = bytes([0x6C, 0x1B, 0x01])


def _read_tsv(path: str) -> List[List[str]]:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                rows.append(parts)
    return rows


def write_bed(prefix: str, X: np.ndarray, snp_ids=None, sample_ids=None,
              chrom=None, pos=None) -> None:
    """Write (n, p) dosages to .bed/.bim/.fam (for tests / fixtures).

    Dosage d maps to the bed code counting A1: 2 -> 00, 1 -> 10, 0 -> 11,
    NaN -> 01 (missing)."""
    from .packed import pack_codes

    n, p = X.shape
    snp_ids = snp_ids or [f"rs{i}" for i in range(p)]
    sample_ids = sample_ids or [f"id{i}" for i in range(n)]
    chrom = chrom if chrom is not None else np.ones(p, dtype=int)
    pos = pos if pos is not None else np.arange(1, p + 1)
    Xf = np.asarray(X, np.float32)
    d = np.rint(np.nan_to_num(Xf, nan=3.0)).astype(np.int16)
    code = np.where(d == 2, 0b00, np.where(d == 1, 0b10, 0b11))
    code = np.where(np.isnan(Xf), 0b01, code).astype(np.uint8)  # (n, p)
    out = np.ascontiguousarray(pack_codes(code).T)  # (p, ceil(n/4))
    with open(prefix + ".bed", "wb") as f:
        f.write(_MAGIC)
        f.write(out.tobytes())
    with open(prefix + ".bim", "w") as f:
        for j in range(p):
            f.write(f"{chrom[j]}\t{snp_ids[j]}\t0\t{pos[j]}\tA\tT\n")
    with open(prefix + ".fam", "w") as f:
        for i in range(n):
            f.write(f"fam{i} {sample_ids[i]} 0 0 0 -9\n")
