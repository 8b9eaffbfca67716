"""Mouse-panel-style GWAS pipeline on PyTorch (``pygemma_tpu_torch``).

The same pipeline, flags and outputs as ``run_gwas.py`` beside it (reference
experiments/animal_gwas/run_gwas.py): genotype load -> mean imputation ->
GRM -> PCA covariates -> LMM scan -> lambda_GC -> manhattan + QQ plots.  The
default input is a simulated panel with the mouse_hs1940 shape (1,940 mice x
12k SNPs); pass --bfile to run on real PLINK data.  The GRM and the scan run
on ``--device`` (the card by default; ``--device cpu`` on the CPU):

    python experiments/animal_gwas/run_gwas_torch.py --out-dir out
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bfile", help="PLINK prefix; default = simulated panel")
    ap.add_argument("--n", type=int, default=1940)
    ap.add_argument("--p", type=int, default=12226)
    ap.add_argument("--pcs", type=int, default=2)
    ap.add_argument("--out-dir", default="output")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    from pygemma_tpu_torch import plotting
    from pygemma_tpu_torch import preprocess as pp
    from pygemma_tpu_torch import pygemma
    from pygemma_tpu_torch.io.kinship import kinship_blocked

    os.makedirs(args.out_dir, exist_ok=True)

    if args.bfile:
        from pygemma_tpu_torch.io import bimbam, read_bed

        d = read_bed(args.bfile)
        X, names = pp.mean_impute(d.X), d.snp_ids
        chrom, pos = d.chrom, d.pos
        # phenotype expected as <bfile>.pheno.txt, one value per line
        y = bimbam.read_pheno(args.bfile + ".pheno.txt")
        keep = np.isfinite(y)
        y, X = y[keep], X[keep]
    else:
        from pygemma_tpu_torch.sim import simulate_gwas

        d = simulate_gwas(n=args.n, p=args.p, n_causal=10, pve=0.3,
                          h2_poly=0.4, seed=1940)
        X, y, names = d.X, d.Y, [f"rs{i}" for i in range(args.p)]
        chrom = np.repeat(np.arange(1, 20), int(np.ceil(args.p / 19)))[: args.p]
        pos = np.arange(args.p)

    X, names, keepc = pp.drop_zero_variance(X, names)
    chrom, pos = chrom[keepc], pos[keepc]

    K = kinship_blocked(X, device=args.device)  # GRM (reference :45-55)
    W = np.c_[np.ones(len(y)), pp.pca_covariates(X, n_pcs=args.pcs)]

    t0 = time.time()
    df = pygemma(y, X, W, K, snps=names, verbose=1, device=args.device)
    print(f"scan: {time.time() - t0:.1f}s", file=sys.stderr)
    df["chrom"], df["pos"] = chrom, pos

    lam_gc = pp.genomic_control_lambda(df["p_wald"])
    print(f"lambda_GC = {lam_gc:.4f}")  # reference :185

    df.to_csv(os.path.join(args.out_dir, "assoc.tsv"), sep="\t", index=False)
    if plotting.available():
        plotting.manhattan_plot(
            df, save_path=os.path.join(args.out_dir, "manhattan.png"))
        plotting.qq_plot(df["p_wald"],
                         save_path=os.path.join(args.out_dir, "qq.png"))
        print(f"wrote {args.out_dir}/assoc.tsv + plots")
    else:
        print(f"wrote {args.out_dir}/assoc.tsv (no plots: matplotlib is not "
              "installed)")


if __name__ == "__main__":
    main()
