"""PLINK binary (.bed/.bim/.fam) reader and writer.

.bed layout: 3 magic bytes (0x6c 0x1b 0x01 = SNP-major), then per SNP
ceil(n/4) bytes, 2 bits per sample:
    00 -> homozygous A1   01 -> missing   10 -> het   11 -> homozygous A2

Two ways in.  :meth:`pygemma_tpu_torch.io.packed.PackedMatrix.open_bed`
streams a .bed's data bytes verbatim and decodes them on the device;
:func:`read_bed` decodes on the host into a float32 dosage matrix, with the
native C++ decoder (``native/bed_reader.cpp``) or, when asked, a vectorized
NumPy lookup table.  The reference ingests PLINK data through pysnptools
(experiments/wtccc/run_pygemma.py:381-400).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from ..native import bed_native

_MAGIC = bytes([0x6C, 0x1B, 0x01])


class PlinkData(NamedTuple):
    X: np.ndarray  # (n, p) float32 dosages, NaN = missing
    snp_ids: List[str]
    sample_ids: List[str]
    chrom: np.ndarray
    pos: np.ndarray


def _decode_table(count_a1: bool) -> np.ndarray:
    """256 -> 4 sample dosages lookup table."""
    if count_a1:
        code = {0b00: 2.0, 0b01: np.nan, 0b10: 1.0, 0b11: 0.0}
    else:
        code = {0b00: 0.0, 0b01: np.nan, 0b10: 1.0, 0b11: 2.0}
    table = np.empty((256, 4), dtype=np.float32)
    for byte in range(256):
        for k in range(4):
            table[byte, k] = code[(byte >> (2 * k)) & 0b11]
    return table


def read_bed(
    prefix: str,
    snp_indices: Optional[Sequence[int]] = None,
    count_a1: bool = True,
    use_native: bool = True,
) -> PlinkData:
    """Read ``prefix``.bed/.bim/.fam -> (n, p) float32 dosage matrix.

    ``snp_indices`` selects a subset of SNP columns without decoding the rest
    (the streaming-selective design point of the reference's C++
    matrix_reader, experiments/benchmarks/matrix_reader.cpp:29-101).
    ``count_a1=True`` matches pysnptools' default allele counting.
    ``use_native=True`` decodes with the C++ reader and raises if it cannot
    be built; ``use_native=False`` is the NumPy decoder.
    """
    bim = _read_tsv(prefix + ".bim")
    fam = _read_tsv(prefix + ".fam")
    n = len(fam)
    p_all = len(bim)
    bytes_per_snp = (n + 3) // 4

    with open(prefix + ".bed", "rb") as f:
        if f.read(3) != _MAGIC:
            raise ValueError(f"{prefix}.bed: bad magic / not SNP-major")

    if snp_indices is None:
        snp_idx = np.arange(p_all)
    else:
        snp_idx = np.asarray(list(snp_indices), dtype=np.int64)
        if snp_idx.size and (snp_idx.min() < 0 or snp_idx.max() >= p_all):
            raise IndexError(
                f"snp_indices outside [0, {p_all}) for {prefix}.bed")

    if use_native:
        X = bed_native.decode_bed(prefix + ".bed", n, bytes_per_snp, snp_idx,
                                  count_a1)
    else:
        raw = np.memmap(prefix + ".bed", dtype=np.uint8, mode="r", offset=3)
        raw = raw.reshape(p_all, bytes_per_snp)
        decoded = _decode_table(count_a1)[raw[snp_idx]]  # (p_sel, bps, 4)
        X = decoded.reshape(len(snp_idx), -1)[:, :n].T.copy()  # (n, p_sel)

    return PlinkData(
        X=X,
        snp_ids=[bim[i][1] for i in snp_idx],
        sample_ids=[r[1] for r in fam],
        chrom=np.asarray([bim[i][0] for i in snp_idx]),
        pos=np.asarray([int(bim[i][3]) for i in snp_idx], dtype=np.int64),
    )


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
    Xf = np.asarray(X, np.float32)
    d = np.rint(np.nan_to_num(Xf, nan=3.0)).astype(np.int16)
    code = np.where(d == 2, 0b00, np.where(d == 1, 0b10, 0b11))
    code = np.where(np.isnan(Xf), 0b01, code).astype(np.uint8)  # (n, p)
    out = np.ascontiguousarray(pack_codes(code).T)  # (p, ceil(n/4))
    with open(prefix + ".bed", "wb") as f:
        f.write(_MAGIC)
        f.write(out.tobytes())
    write_bim_fam(prefix, n, p, snp_ids, sample_ids, chrom, pos)


def write_bim_fam(prefix: str, n: int, p: int, snp_ids=None, sample_ids=None,
                  chrom=None, pos=None) -> None:
    """Write the .bim and .fam text sidecars of an n x p fileset."""
    snp_ids = snp_ids or [f"rs{i}" for i in range(p)]
    sample_ids = sample_ids or [f"id{i}" for i in range(n)]
    chrom = chrom if chrom is not None else np.ones(p, dtype=int)
    pos = pos if pos is not None else np.arange(1, p + 1)
    with open(prefix + ".bim", "w") as f:
        for j in range(p):
            f.write(f"{chrom[j]}\t{snp_ids[j]}\t0\t{pos[j]}\tA\tT\n")
    with open(prefix + ".fam", "w") as f:
        for i in range(n):
            f.write(f"fam{i} {sample_ids[i]} 0 0 0 -9\n")
