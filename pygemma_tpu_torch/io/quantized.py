"""int8 genotype streaming: dosage codes over the host->device link,
per-column affine dequantization on the device.

Genotypes are 3-level dosages {0, 1, 2}; the standardized float32 column the
scan consumes is an exact per-column affine map of the int8 code:
``x = (g - mu_j) / sd_j``.  Shipping int8 codes plus two (p,) vectors cuts
host->device traffic 4x against float32; the affine runs on the device in
float32, so the block is bit-identical to the host slice.

Missing dosages use a sentinel code (default -9) and dequantize to the
column mean, i.e. standardized value 0 (mean imputation).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: sentinel int8 code for a missing dosage (never a valid 0/1/2 dosage)
MISSING_CODE = -9


class QuantizedMatrix:
    """(n, p) genotype matrix stored as int8 codes + per-column affine.

    Array-like for ``pygemma(X=...)``: host slicing (``Q[:, a:b]``)
    dequantizes to float32; the SNP-block streamer ships the int8 codes and
    dequantizes on the device.

    ``data``: (n, p) int8 ndarray or memmap.
    ``mu``/``sd``: (p,) float32 per-column shift/scale; the dequantized
    value is ``(g - mu) / sd`` (missing codes -> 0).
    """

    def __init__(self, data: np.ndarray, mu: np.ndarray, sd: np.ndarray,
                 missing_code: int = MISSING_CODE):
        if data.dtype != np.int8:
            raise TypeError(f"data must be int8, got {data.dtype}")
        self.data = data
        self.mu = np.asarray(mu, np.float32).reshape(-1)
        self.sd = np.asarray(sd, np.float32).reshape(-1)
        if self.mu.shape[0] != data.shape[1] or self.sd.shape[0] != data.shape[1]:
            raise ValueError("mu/sd must have one entry per column")
        self.missing_code = int(missing_code)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.data.shape

    @property
    def dtype(self):
        # what the scan consumes after dequantization
        return np.dtype(np.float32)

    def __getitem__(self, idx) -> np.ndarray:
        """Host-side dequantized float32 slice."""
        g = self.data[idx]
        if isinstance(idx, tuple) and len(idx) == 2:
            mu, sd = self.mu[idx[1]], self.sd[idx[1]]
        else:
            mu, sd = self.mu, self.sd
        if np.ndim(g) == 0:  # scalar entry: same imputation as array slices
            if g == self.missing_code:
                return np.float32(0.0)
            return np.float32((np.float32(g) - mu) / sd)
        x = g.astype(np.float32)
        if np.any(g == self.missing_code):
            x = np.where(g == self.missing_code, mu, x)
        return (x - mu) / sd

    def quant_block(self, start: int, stop: int):
        """(int8 codes, mu, sd) for columns [start, stop) -- raw, unpadded."""
        return (np.ascontiguousarray(self.data[:, start:stop]),
                self.mu[start:stop], self.sd[start:stop])

    def cols(self, start: int, stop: int) -> "QuantizedMatrix":
        """Zero-copy view of a column (SNP) range."""
        return QuantizedMatrix(self.data[:, start:stop],
                               self.mu[start:stop], self.sd[start:stop],
                               self.missing_code)

    @classmethod
    def from_dosages(cls, G, mode: str = "standardize",
                     missing_code: int = MISSING_CODE,
                     eps: float = 1e-6, block: int = 16384,
                     out: Optional[np.ndarray] = None) -> "QuantizedMatrix":
        """Build from an (n, p) integer dosage matrix (ndarray or memmap).

        ``mode``: "standardize" -> (g - mean)/std per column; "center" ->
        g - mean.  Missing entries (== missing_code) are left out of the
        statistics and dequantize to the column mean.  Statistics are
        computed in one blocked host pass, so large memmaps never fully
        materialize.  An int8 ndarray input is aliased, not copied.
        """
        if mode not in ("standardize", "center"):
            raise ValueError(
                f"mode must be 'standardize' or 'center', got {mode!r}")
        n, p = G.shape
        mu = np.empty(p, np.float32)
        sd = np.ones(p, np.float32)
        for s in range(0, p, block):
            e = min(s + block, p)
            g = np.asarray(G[:, s:e])
            miss = g == missing_code
            x = g.astype(np.float32)
            cnt = np.maximum((~miss).sum(0), 1)
            m = np.where(miss, 0, x).sum(0) / cnt
            mu[s:e] = m
            if mode == "standardize":
                # impute-then-standardize: imputed entries sit at the mean
                # but still count in the denominator
                v = (np.where(miss, 0.0, (x - m) ** 2)).sum(0) / n
                sd[s:e] = np.maximum(np.sqrt(v), eps)
        data = G if (isinstance(G, np.ndarray) and G.dtype == np.int8
                     and out is None) else None
        if data is None:
            data = out if out is not None else np.empty((n, p), np.int8)
            for s in range(0, p, block):
                e = min(s + block, p)
                g = np.asarray(G[:, s:e])
                if g.dtype != np.int8:
                    # an int8 cast wraps silently; reject out-of-range codes
                    if ((g < -128) | (g > 127)).any():
                        raise ValueError(
                            "dosage values outside int8 range in columns "
                            f"[{s}, {e}); remap the missing code into int8 "
                            "range before quantizing")
                data[:, s:e] = g.astype(np.int8)
        return cls(data, mu, sd, missing_code)

    @classmethod
    def open_rawbin(cls, prefix: str) -> "QuantizedMatrix":
        """Open ``<prefix>.i8`` ((p, n) int8, one SNP per row -- written by
        :func:`write_rawbin_i8`) with its ``<prefix>.dim`` and
        ``<prefix>.scale.npz`` (mu, sd) sidecars, as a lazy memmap."""
        from .rawbin import read_dim

        rows, cols = read_dim(prefix + ".dim")  # (p, n) layout on disk
        mm = np.memmap(prefix + ".i8", dtype=np.int8, mode="r",
                       shape=(rows, cols))
        with np.load(prefix + ".scale.npz") as z:
            mu, sd = z["mu"], z["sd"]
        return cls(mm.T, mu, sd)


def write_rawbin_i8(prefix: str, data_pn: np.ndarray, mu: np.ndarray,
                    sd: np.ndarray) -> None:
    """Persist a quantized matrix: ``.i8`` holds (p, n) int8 row-major (one
    SNP per row, so column blocks of the logical (n, p) matrix are
    contiguous reads), ``.dim`` holds "p n", ``.scale.npz`` holds mu/sd."""
    data_pn = np.ascontiguousarray(data_pn, dtype=np.int8)
    data_pn.tofile(prefix + ".i8")
    with open(prefix + ".dim", "w") as f:
        f.write(f"{data_pn.shape[0]} {data_pn.shape[1]}\n")
    np.savez(prefix + ".scale.npz", mu=np.asarray(mu, np.float32),
             sd=np.asarray(sd, np.float32))


def dequantize_device(g_i8: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor,
                      missing_code: int = MISSING_CODE) -> torch.Tensor:
    """Affine dequantization on the codes' device: (n, B) int8 -> float32
    ``(g - mu) / sd`` with missing codes mapped to 0 (mean imputation)."""
    x = g_i8.to(torch.float32)
    x = torch.where(g_i8 == missing_code, mu[None, :], x)
    return (x - mu[None, :]) / sd[None, :]
