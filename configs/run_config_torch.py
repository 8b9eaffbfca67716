"""Run the BASELINE.json scenario configs at feasible scale on PyTorch
(``pygemma_tpu_torch``).

The five scenarios of ``run_config.py`` beside it, with the same shapes,
seeds and printed reports, on ``--device`` (the card by default):

    python configs/run_config_torch.py --name mouse_hs1940
    python configs/run_config_torch.py --name bxd
    python configs/run_config_torch.py --name gd449_multi
    python configs/run_config_torch.py --name ukb_synth --scale 0.1
    python configs/run_config_torch.py --name large_gwas_sharded
    torchrun --nproc-per-node 4 configs/run_config_torch.py \\
        --name large_gwas_sharded

Real cohort genotypes are not distributable, so each scenario uses the
simulator at the config's shape (``--scale`` shrinks it).  ``ukb_synth``
writes its 2-bit cohort under ``--cache-dir`` (by default the directory
``run_config.py`` uses; the NumPy generation is the same, so both share its
files).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: ukb_synth's cohort files, shared with run_config.py
UKB_SYNTH_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               ".ukb_synth_cache")


def _report(name, df, t, extra=""):
    from pygemma_tpu_torch.preprocess import genomic_control_lambda

    print(
        f"[{name}] {len(df)} rows in {t:.1f}s | "
        f"lambda_GC={genomic_control_lambda(df['p_wald']):.3f} | "
        f"min p={np.nanmin(df['p_wald']):.2e} {extra}"
    )


def mouse_hs1940(scale, device="cuda"):
    """1,940 samples x ~12k SNPs, single phenotype, Wald."""
    from pygemma_tpu_torch import pygemma
    from pygemma_tpu_torch.sim import simulate_gwas

    n, p = int(1940 * scale), int(12226 * scale)
    d = simulate_gwas(n=n, p=p, n_causal=10, pve=0.3, h2_poly=0.4, seed=1940)
    t0 = time.time()
    df = pygemma(d.Y, d.X, d.W, d.K, device=device)
    _report("mouse_hs1940", df, time.time() - t0)
    return df


def bxd(scale, device="cuda"):
    """BXD panel shape: ~198 strains x 7,320 SNPs with covariates,
    LRT + score tests."""
    from pygemma_tpu_torch import pygemma
    from pygemma_tpu_torch.sim import simulate_gwas

    n, p = max(64, int(198 * scale)), int(7320 * scale)
    d = simulate_gwas(n=n, p=p, c=3, n_causal=4, pve=0.35, h2_poly=0.3,
                      seed=7320)
    t0 = time.time()
    df = pygemma(d.Y, d.X, d.W, d.K, tests=("wald", "lrt", "score"),
                 device=device)
    ok = np.isfinite(df[["p_wald", "p_lrt", "p_score"]]).mean().min()
    _report("bxd", df, time.time() - t0, f"| finite across tests={ok:.2f}")
    return df


def gd449_multi(scale, device="cuda"):
    """GD449/1000G style: multi-phenotype loop with grid-search lambda."""
    from pygemma_tpu_torch import pygemma
    from pygemma_tpu_torch.sim import simulate_gwas

    n, p, k = int(449 * scale) + 50, int(100000 * scale), 3
    d = simulate_gwas(n=n, p=p, seed=449)
    rng = np.random.default_rng(449)
    Y = np.stack([d.Y] + [
        (d.X @ (rng.normal(size=p) * (rng.random(p) < 0.001))
         + rng.normal(size=n)).astype(np.float32)
        for _ in range(k - 1)
    ], axis=1)
    t0 = time.time()
    df = pygemma(Y, d.X, d.W, d.K, grid=True, device=device)
    _report("gd449_multi", df, time.time() - t0,
            f"| phenos={df['pheno'].nunique()}")
    return df


def ukb_synth(scale, device="cuda", cache_dir=UKB_SYNTH_CACHE):
    """UKB-scale synthetic: 50k x 100k, streamed SNP blocks.

    The cohort is generated straight to an on-disk 2-bit packed file
    (io/packed.py; ~1.25 GB at full scale, never a float64 matrix in RAM)
    and the kinship is the exact low-rank GRM over a SNP subset, so the scan
    streams PLINK-density blocks and the eigendecomposition never builds
    the n x n matrix.
    """
    from pygemma_tpu_torch import GwasConfig, LowRankKinship, pygemma
    from pygemma_tpu_torch.io.packed import PackedMatrix, pack_codes

    n, p = int(50000 * scale), int(100000 * scale)
    k_snps = min(16384, max(64, n // 2), p)
    print(f"[ukb_synth] n={n} p={p} kinship_snps={k_snps} (scale={scale})")
    os.makedirs(cache_dir, exist_ok=True)
    prefix = os.path.join(cache_dir, f"geno_n{n}_p{p}")
    if not os.path.exists(prefix + ".2b"):
        rng = np.random.default_rng(50)
        mu = np.empty(p, np.float32)
        sd = np.empty(p, np.float32)
        block = 4096
        with open(prefix + ".2b", "wb") as f:
            for s in range(0, p, block):
                b = min(block, p - s)
                Gb = rng.binomial(2, 0.3, size=(b, n)).astype(np.uint8)
                xf = Gb.astype(np.float32)
                mu[s:s + b] = xf.mean(1)
                sd[s:s + b] = np.maximum(xf.std(1), 1e-6)
                f.write(np.ascontiguousarray(pack_codes(Gb.T).T).tobytes())
        with open(prefix + ".dim", "w") as f:
            f.write(f"{p} {n}\n")
        np.savez(prefix + ".scale.npz", mu=mu, sd=sd)
    X = PackedMatrix.open_rawbin(prefix)
    rng = np.random.default_rng(51)
    causal = rng.choice(p, size=50, replace=False)
    y = (np.asarray(X[:, causal]).sum(1) * np.sqrt(0.25 / 50)
         + rng.standard_normal(n) * np.sqrt(0.75)).astype(np.float32)
    W = np.c_[np.ones(n), rng.standard_normal((n, 2))].astype(np.float32)
    lrk = LowRankKinship(X.cols(0, k_snps), eps=1e-3)
    t0 = time.time()
    df = pygemma(y, X, W, lrk, config=GwasConfig(snp_block=4096),
                 verbose=1, device=device)
    _report("ukb_synth", df, time.time() - t0)
    return df


def large_gwas_sharded(scale, device="cuda"):
    """The scan SNP-sharded over a mesh of the launcher's ranks (a
    one-rank world without a launcher), the eigenbasis computed on rank 0
    and replicated.  With four or more ranks (an even count) the mesh gets
    a ``sample`` axis of 2."""
    import torch.distributed as dist

    from pygemma_tpu_torch import GwasConfig, pygemma
    from pygemma_tpu_torch.parallel import distributed
    from pygemma_tpu_torch.parallel.mesh import make_mesh
    from pygemma_tpu_torch.sim import simulate_gwas

    started = not dist.is_initialized()
    distributed.initialize(device=device)
    try:
        world = dist.get_world_size()
        sample = 2 if world >= 4 and world % 2 == 0 else 1
        mesh = make_mesh(snp=world // sample, sample=sample, device=device)
        n, p = int(2000 * scale) + 128, int(8000 * scale) + 256
        d = simulate_gwas(n=n, p=p, seed=99)
        t0 = time.time()
        df = pygemma(d.Y, d.X, d.W, d.K, mesh=mesh, device=device,
                     config=GwasConfig(eigh_backend="device"))
        if dist.get_rank() == 0:
            _report("large_gwas_sharded", df, time.time() - t0,
                    f"| mesh={dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")
    finally:
        if started:
            dist.destroy_process_group()
    return df


SCENARIOS = {
    "mouse_hs1940": mouse_hs1940,
    "bxd": bxd,
    "gd449_multi": gd449_multi,
    "ukb_synth": ukb_synth,
    "large_gwas_sharded": large_gwas_sharded,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", required=True, choices=sorted(SCENARIOS))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cache-dir", default=UKB_SYNTH_CACHE,
                    help="where ukb_synth writes its 2-bit cohort")
    args = ap.parse_args()
    kw = {"cache_dir": args.cache_dir} if args.name == "ukb_synth" else {}
    SCENARIOS[args.name](args.scale, device=args.device, **kw)


if __name__ == "__main__":
    main()
