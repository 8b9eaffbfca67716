"""2-bit packed genotype streaming: PLINK-density codes over the
host->device link, unpack + affine dequantization on the device.

Biallelic dosages take 4 states {0, 1, 2, missing}; 2 bits each is exactly
PLINK .bed density.  Shipping packed bytes plus two (p,) affine vectors cuts
host->device traffic 16x against float32 and 4x against int8 codes
(io/quantized.py).  The unpack is integer shift/mask work on the device and
the affine runs in float32, so a block is bit-identical to the host slice.

Two codings are supported:

* ``dosage``: codes 0/1/2 are the dosage, 3 = missing (the native format).
* ``bed``: raw PLINK .bed codes (00 = hom A1 -> dosage 2, 01 = missing,
  10 = het -> 1, 11 = hom A2 -> 0), so a .bed file's data bytes stream to
  the device verbatim and decode there.

Missing codes dequantize to the column mean (standardized value 0), i.e.
mean imputation.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import torch

#: the native 2-bit missing code (PLINK bed uses 1)
MISSING_2BIT = 3


def pack_codes(codes_np: np.ndarray) -> np.ndarray:
    """(n, B) uint8/int8 codes in {0,1,2,3} -> (ceil(n/4), B) packed uint8.

    Sample i lives in byte i//4 at bit offset 2*(i%4) (PLINK .bed bit
    order); the inverse of :func:`unpack_codes`.
    """
    g = np.asarray(codes_np)
    n = g.shape[0]
    pad = (-n) % 4
    if pad:
        g = np.concatenate([g, np.zeros((pad,) + g.shape[1:], g.dtype)])
    g = g.astype(np.uint8)
    return (g[0::4] | (g[1::4] << 2) | (g[2::4] << 4) | (g[3::4] << 6))


def unpack_codes(packed: np.ndarray, n: int) -> np.ndarray:
    """(n4, B) packed uint8 -> (n, B) uint8 codes (host-side inverse)."""
    parts = np.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)], axis=1)
    return parts.reshape(-1, *packed.shape[1:])[:n]


def _decode_dosage(codes: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """codes {0,1,2} -> dosage, 3 -> mu (mean imputation), float32."""
    return torch.where(codes == MISSING_2BIT, mu, codes.to(torch.float32))


def _decode_bed(codes: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """PLINK bed codes: 00 -> 2, 01 -> missing, 10 -> 1, 11 -> 0."""
    t = 3 - codes
    d = (t - (t >> 1)).to(torch.float32)  # ceil((3-c)/2): 0->2, 2->1, 3->0
    return torch.where(codes == 1, mu, d)


def dequantize_packed_device(packed_u8: torch.Tensor, mu: torch.Tensor,
                             sd: torch.Tensor, n: int,
                             coding: str = "dosage") -> torch.Tensor:
    """2-bit unpack + affine dequantization on the codes' device.

    packed_u8: (ceil(n/4), B) uint8; mu/sd: (B,) float32 per-column affine.
    Returns the (n, B) standardized float32 block ``(dosage - mu) / sd``
    with missing mapped to 0.
    """
    n4, B = packed_u8.shape
    parts = torch.stack([(packed_u8 >> s) & 3 for s in (0, 2, 4, 6)], dim=1)
    codes = parts.reshape(n4 * 4, B)[:n]
    decode = _decode_bed if coding == "bed" else _decode_dosage
    x = decode(codes, mu[None, :])
    return (x - mu[None, :]) / sd[None, :]


def _host_decode(codes: np.ndarray, mu, coding: str) -> np.ndarray:
    if coding == "bed":
        t = 3 - codes.astype(np.int16)
        x = (t - (t >> 1)).astype(np.float32)
        return np.where(codes == 1, mu, x)
    x = codes.astype(np.float32)
    return np.where(codes == MISSING_2BIT, mu, x)


def _column_stats(codes: np.ndarray, coding: str, standardize: bool,
                  eps: float) -> Tuple[np.ndarray, np.ndarray]:
    """Missing-aware column mean and (impute-then-standardize) sd."""
    n = codes.shape[0]
    missing = 1 if coding == "bed" else MISSING_2BIT
    if coding == "bed":
        t = 3 - codes.astype(np.int16)
        dose = (t - (t >> 1)).astype(np.float32)
    else:
        dose = codes.astype(np.float32)
    miss = codes == missing
    cnt = np.maximum((~miss).sum(0), 1)
    mu = np.where(miss, 0, dose).sum(0) / cnt
    if standardize:
        v = (np.where(miss, 0.0, (dose - mu) ** 2)).sum(0) / n
        sd = np.maximum(np.sqrt(v), eps)
    else:
        sd = np.ones(codes.shape[1], np.float32)
    return mu, sd


class PackedMatrix:
    """(n, p) genotype matrix stored as 2-bit codes + per-column affine.

    Array-like for ``pygemma(X=...)`` like
    :class:`pygemma_tpu_torch.io.quantized.QuantizedMatrix`: host slicing
    dequantizes to float32; the SNP-block streamer ships the packed bytes
    and unpacks on the device.

    ``data``: (ceil(n/4), p) uint8 ndarray or memmap, one packed sample
    group per row -- the transpose of the on-disk (p, n4) layout, which is
    a PLINK .bed body.
    """

    def __init__(self, data: np.ndarray, n: int, mu: np.ndarray,
                 sd: np.ndarray, coding: str = "dosage"):
        if data.dtype != np.uint8:
            raise TypeError(f"packed data must be uint8, got {data.dtype}")
        if coding not in ("dosage", "bed"):
            raise ValueError(f"coding must be 'dosage' or 'bed': {coding!r}")
        if data.shape[0] != (n + 3) // 4:
            raise ValueError(
                f"packed rows {data.shape[0]} != ceil(n/4) for n={n}")
        self.data = data
        self.n = int(n)
        self.mu = np.asarray(mu, np.float32).reshape(-1)
        self.sd = np.asarray(sd, np.float32).reshape(-1)
        if self.mu.shape[0] != data.shape[1] or self.sd.shape[0] != data.shape[1]:
            raise ValueError("mu/sd must have one entry per column")
        self.coding = coding
        #: where the codes come from ("<abspath>:<mtime>", plus "+<offset>"
        #: for a ``cols`` view); set by the file-backed constructors.  None
        #: (in-memory codes) keeps the matrix out of the device block cache.
        self.source: Optional[str] = None

    @property
    def cache_token(self) -> Optional[str]:
        """Identity of this matrix's device blocks (io/streaming.py's block
        cache): the source plus a digest of the affine actually in use, so
        two matrices over one file with different mu/sd never share an
        entry."""
        if self.source is None:
            return None
        h = hashlib.blake2b(digest_size=16)
        h.update(self.coding.encode())
        h.update(self.mu.tobytes())
        h.update(self.sd.tobytes())
        return f"{self.source}:{h.hexdigest()}"

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.data.shape[1])

    @property
    def dtype(self):
        return np.dtype(np.float32)

    def __getitem__(self, idx) -> np.ndarray:
        """Host-side dequantized float32 slice.  Column slices are cheap
        (contiguous packed reads); row indexing decodes the full sample
        axis first."""
        if isinstance(idx, tuple) and len(idx) == 2:
            rows, cols = idx
        else:
            rows, cols = idx, slice(None)
        packed = np.asarray(self.data[:, cols])
        mu, sd = self.mu[cols], self.sd[cols]
        codes = unpack_codes(packed, self.n)[rows]
        x = _host_decode(codes, mu, self.coding)
        return ((x - mu) / sd).astype(np.float32)

    def quant_block(self, start: int, stop: int):
        """Raw (packed bytes, mu, sd) for columns [start, stop)."""
        return (np.ascontiguousarray(self.data[:, start:stop]),
                self.mu[start:stop], self.sd[start:stop])

    def cols(self, start: int, stop: int) -> "PackedMatrix":
        """Zero-copy view of a column (SNP) range -- e.g. the kinship SNP
        subset of a cohort (``LowRankKinship(X.cols(0, 16384))``)."""
        sub = PackedMatrix(self.data[:, start:stop], self.n,
                           self.mu[start:stop], self.sd[start:stop],
                           self.coding)
        if self.source is not None:
            sub.source = f"{self.source}+{start}"
        return sub

    @classmethod
    def from_codes(cls, codes: np.ndarray, mu=None, sd=None,
                   coding: str = "dosage", eps: float = 1e-6,
                   standardize: bool = True) -> "PackedMatrix":
        """Build from an (n, p) small-integer code matrix.  When mu/sd are
        omitted they are computed from the codes (missing-aware)."""
        codes = np.asarray(codes)
        n, _ = codes.shape
        if mu is None or sd is None:
            mu, sd = _column_stats(codes, coding, standardize, eps)
        return cls(pack_codes(codes), n, mu, sd, coding)

    @classmethod
    def open_rawbin(cls, prefix: str) -> "PackedMatrix":
        """Open ``<prefix>.2b`` ((p, ceil(n/4)) uint8 row-major, written by
        :func:`write_rawbin_2bit`) with ``.dim``/``.scale.npz`` sidecars."""
        from .rawbin import read_dim

        p, n = read_dim(prefix + ".dim")
        n4 = (n + 3) // 4
        mm = np.memmap(prefix + ".2b", dtype=np.uint8, mode="r",
                       shape=(p, n4))
        with np.load(prefix + ".scale.npz") as z:
            mu, sd = z["mu"], z["sd"]
        self = cls(mm.T, n, mu, sd)
        path = os.path.abspath(prefix + ".2b")
        self.source = f"{path}:{os.path.getmtime(path)}"
        return self

    @classmethod
    def open_bed(cls, prefix: str, mu=None, sd=None,
                 standardize: bool = True, eps: float = 1e-6,
                 block: int = 16384) -> "PackedMatrix":
        """Wrap a PLINK .bed/.bim/.fam fileset as a lazily streamed matrix.

        The .bed data bytes (SNP-major, 2-bit) are memmapped verbatim and
        ship to the device unmodified; the decode happens there.  Column
        statistics for the standardizing affine are computed in one blocked
        host pass when not supplied.
        """
        from .plink import _MAGIC, _read_tsv

        fam = _read_tsv(prefix + ".fam")
        bim = _read_tsv(prefix + ".bim")
        n, p = len(fam), len(bim)
        n4 = (n + 3) // 4
        with open(prefix + ".bed", "rb") as f:
            magic = f.read(3)
        if magic != _MAGIC:
            raise ValueError(f"{prefix}.bed: not a SNP-major PLINK bed file")
        mm = np.memmap(prefix + ".bed", dtype=np.uint8, mode="r",
                       offset=3, shape=(p, n4))
        if mu is None or sd is None:
            mu = np.empty(p, np.float32)
            sd = np.ones(p, np.float32)
            for s in range(0, p, block):
                e = min(s + block, p)
                codes = unpack_codes(np.asarray(mm[s:e]).T, n)
                mu[s:e], sd[s:e] = _column_stats(codes, "bed", standardize,
                                                 eps)
        self = cls(mm.T, n, mu, sd, coding="bed")
        path = os.path.abspath(prefix + ".bed")
        self.source = f"{path}:{os.path.getmtime(path)}"
        return self


def write_rawbin_2bit(prefix: str, codes_np_or_packed_pn: np.ndarray,
                      mu: np.ndarray, sd: np.ndarray,
                      n: Optional[int] = None) -> None:
    """Persist a packed matrix: ``.2b`` holds (p, ceil(n/4)) uint8 row-major
    (one SNP per row), ``.dim`` holds "p n", ``.scale.npz`` holds mu/sd.

    Accepts either raw (n, p) codes (packed here) or an already packed
    (p, n4) array with ``n`` given.
    """
    a = np.asarray(codes_np_or_packed_pn)
    if n is None:
        n = a.shape[0]
        packed_pn = np.ascontiguousarray(pack_codes(a).T)
    else:
        packed_pn = np.ascontiguousarray(a, dtype=np.uint8)
    packed_pn.tofile(prefix + ".2b")
    with open(prefix + ".dim", "w") as f:
        f.write(f"{packed_pn.shape[0]} {n}\n")
    np.savez(prefix + ".scale.npz", mu=np.asarray(mu, np.float32),
             sd=np.asarray(sd, np.float32))
