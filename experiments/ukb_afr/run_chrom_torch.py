"""UKB-AFR-style per-chromosome biobank GWAS pipeline on PyTorch
(``pygemma_tpu_torch``).

The same flags, outputs and file names as ``run_chrom.py`` beside it; the
GRM and every scan run on ``--device`` (the card by default):

    python experiments/ukb_afr/run_chrom_torch.py --null-diagnostics

Reference workload being reproduced (experiments/ukb_afr/code/run_snp.py):
per-chromosome PLINK bed ingest (:49-69), mean imputation of genotypes and
phenotype (:72-86), quantile-normalized + standardized phenotype (:90-92),
sex-indicator + PC covariates read from a covariate table or computed by PCA
(:107-131), kinship from file or XX'/p (:97-105), LMM scan + per-chromosome
results CSV + QQ/Manhattan plots (:196-253).  The null-model diagnostics
subcommand mirrors run_without_snp.py:83-111 (OLS fit, residual histogram,
residuals-vs-fitted plot).

Differences by design: chromosomes are a loop over one scan with a shared
kinship eigendecomposition (the reference runs one SLURM job per
chromosome); all inputs default to a simulated cohort so the pipeline is
runnable (and smoke-testable) without the restricted UKB genotypes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def _load_covariates(path: str, n_pcs: int, individuals=None):
    """Sex indicator + standardized PCs from a reference-style covariate
    table (space-separated, 'Inferred.Gender' + 'PC1..PCk' columns;
    run_snp.py:110-121)."""
    import pandas as pd

    covars_df = pd.read_csv(path, sep=" ")
    if individuals is not None:
        covars_df = covars_df.iloc[individuals]
    cols = []
    if "Inferred.Gender" in covars_df.columns:
        cols.append(
            (covars_df["Inferred.Gender"].values == "F")
            .astype(np.float32)[:, None]
        )
    if n_pcs > 0 and "PC1" in covars_df.columns:
        pcs = covars_df[[f"PC{i}" for i in range(1, n_pcs + 1)]].values
        pcs = (pcs - pcs.mean(0)) / pcs.std(0)
        cols.append(pcs.astype(np.float32))
    return np.concatenate(cols, axis=1) if cols else None


def _simulated_chromosomes(n, p_per_chrom, chroms, seed=1807):
    """Simulated multi-chromosome cohort standing in for the restricted UKB
    AFR genotypes (same shapes/dtypes as the bed ingest path)."""
    from pygemma_tpu_torch.sim import simulate_gwas

    d = simulate_gwas(n=n, p=p_per_chrom * len(chroms), n_causal=6, pve=0.25,
                      h2_poly=0.3, seed=seed)
    X_by_chrom = {}
    for i, ch in enumerate(chroms):
        Xc = d.X[:, i * p_per_chrom:(i + 1) * p_per_chrom].copy()
        # sprinkle missingness so the imputation path is exercised
        rng = np.random.default_rng(seed + ch)
        miss = rng.random(Xc.shape) < 0.01
        Xc[miss] = np.nan
        names = [f"{ch}:{100000 + 37 * j}:A:B" for j in range(p_per_chrom)]
        X_by_chrom[ch] = (Xc, names)
    return X_by_chrom, d.Y, d.K


def null_model_diagnostics(y, W, out_dir):
    """OLS null fit + diagnostics (reference run_without_snp.py:83-111); the
    plots only where matplotlib is installed."""
    from pygemma_tpu_torch import plotting

    beta, res_ss, *_ = np.linalg.lstsq(W, y, rcond=None)
    fitted = W @ beta
    resid = y - fitted
    dof = len(y) - W.shape[1]
    sigma2 = float(resid @ resid) / dof
    se = np.sqrt(sigma2 * np.diag(np.linalg.inv(W.T @ W)))
    print("null model OLS: coef =", np.round(beta, 4),
          "se =", np.round(se, 4), f"sigma2 = {sigma2:.4f}",
          file=sys.stderr)
    if not plotting.available():
        print("residual plots skipped: matplotlib is not installed",
              file=sys.stderr)
        return {"beta": beta, "se": se, "sigma2": sigma2}
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 4))
    ax.hist(resid, bins=40)
    ax.set_xlabel("Residuals")
    ax.set_ylabel("Count")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "residuals.png"), dpi=120)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(5, 4))
    ax.scatter(fitted, resid, s=4, alpha=0.6)
    ax.axhline(0.0, color="red", lw=1)
    ax.set_xlabel("Fitted values")
    ax.set_ylabel("Residuals")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "residuals_vs_fitted.png"), dpi=120)
    plt.close(fig)
    return {"beta": beta, "se": se, "sigma2": sigma2}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bed-pattern",
                    help="PLINK prefix pattern with {chrom}, e.g. "
                         "geno/chr_{chrom}; default = simulated cohort")
    ap.add_argument("--chroms", default="20,21",
                    help="comma-separated chromosome list")
    ap.add_argument("--phenotype", help="CSV with id + phenotype columns "
                                        "(run_snp.py:80-92)")
    ap.add_argument("--pheno-idx", type=int, default=0)
    ap.add_argument("--covars", help="space-separated covariate table with "
                                     "Inferred.Gender and PC columns")
    ap.add_argument("--pcs", type=int, default=2)
    ap.add_argument("--kinship", help="TSV kinship matrix; default XX'/p "
                                      "over all chromosomes")
    ap.add_argument("--n", type=int, default=500,
                    help="simulated cohort size")
    ap.add_argument("--p-per-chrom", type=int, default=400)
    ap.add_argument("--null-diagnostics", action="store_true",
                    help="also run the no-SNP OLS diagnostics "
                         "(run_without_snp.py analogue)")
    ap.add_argument("--out-dir", default="ukb_afr_output")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from pygemma_tpu_torch import plotting
    from pygemma_tpu_torch import preprocess as pp
    from pygemma_tpu_torch import pygemma
    from pygemma_tpu_torch.io.kinship import kinship_blocked

    os.makedirs(args.out_dir, exist_ok=True)
    chroms = [int(c) for c in args.chroms.split(",") if c.strip()]

    # --- ingest: per-chromosome genotypes + phenotype -----------------------
    if args.bed_pattern:
        from pygemma_tpu_torch.io import read_bed

        X_by_chrom = {}
        for ch in chroms:
            d = read_bed(args.bed_pattern.format(chrom=ch))
            # rsID -> chrom:pos:ref:alt naming (run_snp.py:69)
            names = [f"{ch}:{rs[2:] if rs.startswith('rs') else rs}:A:B"
                     for rs in d.snp_ids]
            X_by_chrom[ch] = (d.X, names)
        n = next(iter(X_by_chrom.values()))[0].shape[0]
        if args.phenotype is None:
            ap.error("--phenotype is required with --bed-pattern")
        y = None
        K = None
    else:
        X_by_chrom, y, K = _simulated_chromosomes(
            args.n, args.p_per_chrom, chroms
        )
        n = len(y)

    if args.phenotype:
        import pandas as pd

        pheno_df = pd.read_csv(args.phenotype)
        y = pheno_df[pheno_df.columns[1:][args.pheno_idx]] \
            .values.astype(np.float32)

    # mean-impute then qnorm + standardize the phenotype (run_snp.py:83-92)
    y = np.asarray(y, np.float32)
    if np.isnan(y).any():
        y = np.where(np.isnan(y), np.nanmean(y), y)
    y = pp.quantile_normalize(y)
    y = (y - y.mean()) / y.std()

    # mean-impute genotypes per chromosome (run_snp.py:72-75)
    X_by_chrom = {ch: (pp.mean_impute(X), names)
                  for ch, (X, names) in X_by_chrom.items()}

    # --- covariates: intercept + sex + PCs (run_snp.py:95,107-131) ----------
    W = np.ones((n, 1), np.float32)
    extra = _load_covariates(args.covars, args.pcs) \
        if args.covars else None
    if extra is not None:
        W = np.c_[W, extra]
    elif args.pcs > 0:
        X_all = np.concatenate([X for X, _ in X_by_chrom.values()], axis=1)
        W = np.c_[W, pp.pca_covariates(X_all, n_pcs=args.pcs)]

    # --- kinship: file or XX'/p over all chromosomes (run_snp.py:97-105) ----
    if args.kinship:
        import pandas as pd

        K = pd.read_csv(args.kinship, sep="\t", header=None).values \
            .astype(np.float32)
    elif K is None:
        X_all = np.concatenate([X for X, _ in X_by_chrom.values()], axis=1)
        K = kinship_blocked(pp.standardize(X_all, eps=1e-6),
                            device=args.device)

    if args.null_diagnostics:
        null_model_diagnostics(y, W, args.out_dir)

    # --- per-chromosome scans sharing one eigendecomposition ----------------
    # run_dir persists the O(n^3) eigh across the chromosome loop (the
    # reference recomputes it in every per-chromosome SLURM job).
    run_dir = os.path.join(args.out_dir, "checkpoint")
    frames = []
    for ch in chroms:
        X, names = X_by_chrom[ch]
        X, names, _ = pp.drop_zero_variance(X, names)
        t0 = time.time()
        df = pygemma(y, X, W, K, snps=names, run_dir=run_dir,
                     device=args.device)
        print(f"chr{ch}: {X.shape[1]} SNPs in {time.time()-t0:.1f}s, "
              f"lambda_GC={pp.genomic_control_lambda(df['p_wald']):.4f}",
              file=sys.stderr)
        df["chr"] = ch
        df.to_csv(os.path.join(
            args.out_dir,
            f"pygemma_results_chr{ch}_pheno{args.pheno_idx}.csv"),
            index=False)
        # per-chromosome QQ (run_snp.py:202-213)
        if plotting.available():
            plotting.qq_plot(df["p_wald"], save_path=os.path.join(
                args.out_dir, f"chr{ch}_pheno{args.pheno_idx}_wald_qq.png"))
        frames.append(df)
        # fresh run_dir blocks per chromosome (same eigen, new genotypes)
        for f in os.listdir(run_dir):
            if f.startswith("block_"):
                os.remove(os.path.join(run_dir, f))

    # genome-wide Manhattan over all chromosomes (run_snp.py:215-253)
    import pandas as pd

    all_df = pd.concat(frames, ignore_index=True)
    parts = all_df["SNPs"].str.split(":", expand=True)
    all_df["pos"] = parts[1].astype(np.int64)
    all_df["chrom"] = all_df["chr"]
    if plotting.available():
        plotting.manhattan_plot(
            all_df, save_path=os.path.join(args.out_dir, "manhattan.png"))
    else:
        print("plots skipped: matplotlib is not installed", file=sys.stderr)
    all_df.to_csv(os.path.join(args.out_dir, "all_chrom_results.csv"),
                  index=False)
    return all_df


if __name__ == "__main__":
    main()
