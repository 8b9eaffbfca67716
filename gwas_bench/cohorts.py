"""The cells' inputs, drawn on the device from the run's seed.

One generator reads a configuration (``configs/<name>.json``) and a traffic
mix (``traffic/<name>.json``).  Genotypes are codes 0/1/2 drawn per SNP as
two Bernoulli draws of the SNP's allele frequency, block by block on the
device (``chip_smoke.py::make_large_cohort`` / ``make_full_width``, copied
and reseeded), standardized with their own column mean and sd.  They reach
the program as it takes them: 2-bit codes in host memory
(``PackedMatrix``) or a float32 host matrix.  The kinship is the GRM of a
SNP subset plus a ridge (``LowRankKinship``) or the dense K = XX'/p plus a
ridge.  Phenotype 0 has causal SNPs and an optional polygenic term; further
phenotypes follow bench.py:401-423 (each driven by the mean of a slice of
64 SNPs).  Every seed gives the same sizes; only values differ.
"""

from __future__ import annotations

import hashlib
from typing import List, NamedTuple, Optional

import numpy as np
import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of draws of a run's seed."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


class Cohort(NamedTuple):
    """One cohort as the program and the reference both receive it.

    ``packed`` (p, ceil(n/4)) uint8 and ``mu``/``sd`` (p,) float32 for
    2-bit genotypes, else ``X`` (n, p) float32; ``W`` (n, c), ``Y`` (n, k)
    float32; ``K`` (n, n) float32 for a dense kinship (None for a low-rank
    one, which is the GRM of the first ``snps`` columns)."""

    n: int
    p: int
    W: np.ndarray
    Y: np.ndarray
    packed: Optional[np.ndarray]
    mu: Optional[np.ndarray]
    sd: Optional[np.ndarray]
    X: Optional[np.ndarray]
    K: Optional[np.ndarray]

    def columns(self, idx, device) -> torch.Tensor:
        """Standardized float64 genotype columns ``idx`` (n, len(idx)) on
        ``device``, decoded here from the codes (for the reference)."""
        idx = np.asarray(idx)
        if self.X is not None:
            return torch.as_tensor(self.X[:, idx]).to(device, torch.float64)
        pk = torch.as_tensor(self.packed[idx]).to(device)  # (b, n4)
        codes = torch.stack([(pk >> s) & 3 for s in (0, 2, 4, 6)], dim=2)
        codes = codes.reshape(len(idx), -1)[:, :self.n].T.to(torch.float64)
        mu = torch.as_tensor(self.mu[idx]).to(device, torch.float64)
        sd = torch.as_tensor(self.sd[idx]).to(device, torch.float64)
        return (codes - mu) / sd


def pack_on_card(codes: torch.Tensor) -> torch.Tensor:
    """(n, b) uint8 codes -> (ceil(n/4), b) packed bytes, sample i in byte
    i // 4 at bit 2 (i % 4) (PLINK's order, ``io.packed.pack_codes``)."""
    pad = (-codes.shape[0]) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros((pad, codes.shape[1]))])
    c = codes.reshape(-1, 4, codes.shape[1])
    return c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)


def make_cohort(cfg: dict, phenotypes: int, seed: int, device,
                block: int = 4096) -> Cohort:
    """Draw one cohort of configuration ``cfg`` with ``phenotypes``
    phenotype columns from ``seed``, on ``device``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    n, p, c = cfg["n"], cfg["p"], cfg["c"]
    geno, kin, ph = cfg["genotypes"], cfg["kinship"], cfg["phenotype"]
    packed_fmt = geno["format"] == "packed_2bit"

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=g)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    lo, hi = geno["allele_freq"]
    freq = lo + (hi - lo) * rand(p)
    n_causal = ph["causal"]
    causal = torch.randperm(p, device=dev, generator=g)[:n_causal]
    beta = torch.zeros(p, device=dev)
    beta[causal] = randn(n_causal) if ph["effects"] == "normal" else 1.0
    z_poly = randn(p)
    gvec = torch.zeros(n, device=dev)
    upoly = torch.zeros(n, device=dev)
    slices = torch.zeros(n, max(phenotypes - 1, 0), device=dev)
    packed = mu = sd = X = K = Kacc = None
    if packed_fmt:
        packed = np.empty((p, (n + 3) // 4), np.uint8)
        mu = np.empty(p, np.float32)
        sd = np.empty(p, np.float32)
    else:
        X = np.empty((n, p), np.float32)
    if kin["type"] == "dense_grm":
        Kacc = torch.zeros(n, n, device=dev)
    for s in range(0, p, block):
        b = min(block, p - s)
        f = freq[s:s + b]
        codes = ((rand(n, b) < f).to(torch.uint8)
                 + (rand(n, b) < f).to(torch.uint8))
        xf = codes.float()
        m_b = xf.mean(0)
        sd_b = torch.clamp_min(xf.std(0, correction=0), 1e-6)
        xb = (xf - m_b) / sd_b
        gvec += xb @ beta[s:s + b]
        upoly += xb @ z_poly[s:s + b]
        for i in range(slices.shape[1]):
            lo_i, hi_i = 64 * (i + 1) - s, 64 * (i + 2) - s
            if 0 <= lo_i and hi_i <= b:
                slices[:, i] = xb[:, lo_i:hi_i].mean(1)
        if packed_fmt:
            packed[s:s + b] = pack_on_card(codes).T.contiguous().cpu().numpy()
            mu[s:s + b] = m_b.cpu().numpy()
            sd[s:s + b] = sd_b.cpu().numpy()
        else:
            X[:, s:s + b] = xb.cpu().numpy()
        if Kacc is not None:
            Kacc += xb @ xb.T
        del codes, xf, xb
    if Kacc is not None:
        Kacc /= p
        Kacc.diagonal().add_(kin["ridge"])
        K = Kacc.cpu().numpy()
        del Kacc

    def scaled(v, var):
        return v * (var ** 0.5) / v.std() if var > 0 else torch.zeros_like(v)

    e_var = 1.0 - ph["pve"] - ph["h2_poly"]
    y = (scaled(gvec, ph["pve"]) + scaled(upoly, ph["h2_poly"])
         + scaled(randn(n), e_var))
    # bench.py:408-412: phenotype i + 1 = 1.6 mean(X[:, 64(i+1):64(i+2)])
    # + N(0, 1)
    cols = [y] + [1.6 * slices[:, i] + randn(n)
                  for i in range(slices.shape[1])]
    Y = torch.stack(cols, dim=1)
    W = torch.ones(n, c, device=dev)
    W[:, 1:] = randn(n, c - 1)
    out = Cohort(n, p, W.cpu().numpy(), Y.cpu().numpy(), packed, mu, sd, X,
                 K)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def make_cohorts(cfg: dict, traffic: dict, seed: int, device) -> List[Cohort]:
    """The traffic's ``cohorts`` cohorts of configuration ``cfg``."""
    return [make_cohort(cfg, traffic["phenotypes"],
                        derive(seed, "cohort", i), device)
            for i in range(traffic["cohorts"])]
