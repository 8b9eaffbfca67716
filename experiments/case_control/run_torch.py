"""WTCCC-style case/control GWAS on PyTorch (``pygemma_tpu_torch``).

The same pipeline, flags and outputs as ``run.py`` beside it (reference
experiments/wtccc/run_pygemma.py): PLINK bed ingest -> QC (drop
zero-variance SNPs, run_pygemma.py:407-410) -> K = XX'/p (:445) -> LMM scan
on the 0/1 phenotype; optional linear regression (env LINEAR, :14-19 ->
--linear here), BIMBAM cross-check inputs (--write-bimbam) and a GEMMA
cross-check when a binary is installed (run_pygemma_imputed.py:448-470).
The GRM, the scan and the regression run on ``--device`` (the card by
default):

    python experiments/case_control/run_torch.py --linear --out-dir cc
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
    ap.add_argument("--bfile", help="PLINK prefix; default = simulated")
    ap.add_argument("--n-cases", type=int, default=1000)
    ap.add_argument("--n-controls", type=int, default=1500)
    ap.add_argument("--p", type=int, default=20000)
    ap.add_argument("--pcs", type=int, default=int(os.environ.get("PCS", 0)))
    ap.add_argument("--linear", action="store_true",
                    default=bool(os.environ.get("LINEAR")))
    ap.add_argument("--write-bimbam", action="store_true",
                    default=bool(os.environ.get("WRITEDATA")),
                    help="write BIMBAM mean-genotype/phenotype/kinship "
                         "cross-check inputs for an external GEMMA run "
                         "(reference run_pygemma_imputed.py:448-470)")
    ap.add_argument("--out-dir", default=os.environ.get("OUTPUT", "cc_output"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    from pygemma_tpu_torch import compare, plotting
    from pygemma_tpu_torch import preprocess as pp
    from pygemma_tpu_torch import pygemma
    from pygemma_tpu_torch.io import bimbam
    from pygemma_tpu_torch.io.kinship import kinship_blocked
    from pygemma_tpu_torch.linreg import linreg

    os.makedirs(args.out_dir, exist_ok=True)

    if args.bfile:
        from pygemma_tpu_torch.io import read_bed

        d = read_bed(args.bfile)
        X = pp.mean_impute(d.X)
        names = d.snp_ids
        y = bimbam.read_pheno(args.bfile + ".pheno.txt")
    else:
        from pygemma_tpu_torch.sim import simulate_gwas

        n = args.n_cases + args.n_controls
        d = simulate_gwas(n=n, p=args.p, n_causal=8, pve=0.2, h2_poly=0.3,
                          seed=2007)  # WTCCC vintage
        liability = d.Y
        thr = np.quantile(liability, 1 - args.n_cases / n)
        y = (liability > thr).astype(np.float32)  # 0/1 case-control
        X, names = d.X, [f"rs{i}" for i in range(args.p)]

    X, names, _ = pp.drop_zero_variance(X, names)
    W = np.ones((len(y), 1), np.float32)
    if args.pcs:
        W = np.c_[W, pp.pca_covariates(X, n_pcs=args.pcs)]

    K = kinship_blocked(X, device=args.device)

    if args.write_bimbam:
        # cross-check inputs for an external `gemma -g ... -p ... -k ...`
        # run: imputed mean genotypes (one BIMBAM row per SNP), one
        # phenotype value per line, dense kinship
        bimbam.write_geno(
            os.path.join(args.out_dir, "cc_genotypes.tsv"), X, names=names
        )
        bimbam.write_pheno(
            os.path.join(args.out_dir, "cc_phenotypes.tsv"), y
        )
        bimbam.write_matrix(
            os.path.join(args.out_dir, "cc_kinship.txt"), K
        )
        print(f"BIMBAM cross-check inputs written to {args.out_dir}",
              file=sys.stderr)

    t0 = time.time()
    df = pygemma(y, X, W, K, snps=names, verbose=1, device=args.device)
    print(f"LMM scan: {time.time()-t0:.1f}s; "
          f"lambda_GC={pp.genomic_control_lambda(df['p_wald']):.4f}",
          file=sys.stderr)
    df.to_csv(os.path.join(args.out_dir, "lmm.tsv"), sep="\t", index=False)
    if plotting.available():
        plotting.manhattan_plot(
            df, save_path=os.path.join(args.out_dir, "manhattan.png"))
        plotting.qq_plot(df["p_wald"],
                         save_path=os.path.join(args.out_dir, "qq.png"))
    else:
        print("plots skipped: matplotlib is not installed", file=sys.stderr)

    if args.linear:
        df_lin = linreg(y, X, W, snps=names, device=args.device)
        df_lin.to_csv(os.path.join(args.out_dir, "linreg.tsv"), sep="\t",
                      index=False)

    # cross-check against a real GEMMA binary when one is installed
    if compare.find_gemma() and X.shape[1] <= 5000:
        ref = compare.run_gemma(y, X, W[:, 1:] if W.shape[1] > 1 else None, K,
                                snps=names)
        if ref is not None:
            print("GEMMA agreement:",
                  compare.compare_pvalues(df, ref), file=sys.stderr)


if __name__ == "__main__":
    main()
