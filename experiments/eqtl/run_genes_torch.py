"""1000G-style cis-eQTL pipeline on PyTorch (``pygemma_tpu_torch``):
per-gene LMM + linear-regression scans, GEMMA cross-checks, and an
aggregation/summary stage.

The same flags, outputs and file names as ``run_genes.py`` beside it
(reference experiments/1000G: run_pyGEMMA.sh:43-52, summary.py,
plot_gemma.py):

* each "gene" is a phenotype column scanned against the genotype matrix
  with a SHARED kinship eigendecomposition, paid once for every gene; work
  shards over genes with TASK_ID/TASK_COUNT.
* ``--pheno-tsv`` ingests a GD449-style phenotype table (IID + phenotype
  columns) as the gene expression matrix; ``--traw`` ingests PLINK .traw
  genotypes.
* ``--gemma-compare`` cross-checks every gene against the GEMMA binary
  (``pygemma_tpu_torch.compare.run_gemma``; skipped when absent).
* ``--summary`` aggregates per-gene outputs: top-SNP table, lambda_GC
  distribution, LMM-vs-OLS(-vs-GEMMA) log10 p R^2, comparison scatter.

The eigendecomposition and the rotations of X, W and every gene run on
``--device`` (the card by default); the rotated X goes to the host once,
because the scan (``pygemma(eigen=False)``) streams its blocks from there:

    python experiments/eqtl/run_genes_torch.py --summary --out-dir eqtl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def _load_genes_from_tsv(path):
    """GD449-style TSV: IID column + one column per phenotype/gene."""
    import pandas as pd

    df = pd.read_csv(path, sep="\t")
    cols = [c for c in df.columns if c.upper() not in ("IID", "FID")]
    return {c: df[c].to_numpy(np.float32) for c in cols}, \
        df[df.columns[0]].astype(str).tolist()


def _r2(a, b):
    m = np.isfinite(a) & np.isfinite(b)
    if m.sum() < 3:
        return float("nan")
    return float(np.corrcoef(a[m], b[m])[0, 1] ** 2)


def summarize(out_dir):
    """Aggregate per-gene outputs (reference summary.py)."""
    import pandas as pd

    from pygemma_tpu_torch.preprocess import genomic_control_lambda

    rows = []
    for gene in sorted(os.listdir(out_dir)):
        gdir = os.path.join(out_dir, gene)
        lmm_f = os.path.join(gdir, "lmm.tsv")
        if not os.path.isdir(gdir) or not os.path.exists(lmm_f):
            continue
        lmm = pd.read_csv(lmm_f, sep="\t")
        row = {"gene": gene, "n_snps": len(lmm)}
        lp = -np.log10(np.maximum(lmm["p_wald"].to_numpy(float), 1e-300))
        top = int(np.nanargmax(lp))
        row.update(top_snp=top, top_p_wald=float(lmm["p_wald"][top]),
                   top_beta=float(lmm["beta"][top]))
        row["lambda_gc_lmm"] = float(
            genomic_control_lambda(lmm["p_wald"].to_numpy(float)))
        ols_f = os.path.join(gdir, "linreg.tsv")
        if os.path.exists(ols_f):
            ols = pd.read_csv(ols_f, sep="\t")
            lo = -np.log10(np.maximum(ols["p_wald"].to_numpy(float), 1e-300))
            row["lambda_gc_ols"] = float(
                genomic_control_lambda(ols["p_wald"].to_numpy(float)))
            row["r2_p_ols"] = _r2(lp, lo)
            row["r2_beta_ols"] = _r2(lmm["beta"].to_numpy(float),
                                     ols["beta"].to_numpy(float))
        gem_f = os.path.join(gdir, "gemma.tsv")
        if os.path.exists(gem_f):
            gem = pd.read_csv(gem_f, sep="\t")
            lg = -np.log10(np.maximum(gem["p_wald"].to_numpy(float), 1e-300))
            row["r2_p_gemma"] = _r2(lp, lg)
            row["r2_beta_gemma"] = _r2(lmm["beta"].to_numpy(float),
                                       gem["beta"].to_numpy(float))
            row["max_dlog10p_gemma"] = float(np.nanmax(np.abs(lp - lg)))
        rows.append(row)
    summary = pd.DataFrame(rows)
    summary.to_csv(os.path.join(out_dir, "summary.csv"), index=False)

    # comparison scatter: LMM vs OLS -log10 p pooled over genes
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        pooled_l, pooled_o = [], []
        for gene in summary["gene"]:
            gdir = os.path.join(out_dir, gene)
            lmm = pd.read_csv(os.path.join(gdir, "lmm.tsv"), sep="\t")
            of = os.path.join(gdir, "linreg.tsv")
            if os.path.exists(of):
                ols = pd.read_csv(of, sep="\t")
                pooled_l.append(-np.log10(np.maximum(
                    lmm["p_wald"].to_numpy(float), 1e-300)))
                pooled_o.append(-np.log10(np.maximum(
                    ols["p_wald"].to_numpy(float), 1e-300)))
        if pooled_l:
            a = np.concatenate(pooled_l)
            b = np.concatenate(pooled_o)
            axes[0].scatter(b, a, s=4, alpha=0.5)
            lim = np.nanmax([a.max(), b.max()]) if len(a) else 1.0
            axes[0].plot([0, lim], [0, lim], "k--", lw=0.8)
            axes[0].set_xlabel("OLS -log10 p")
            axes[0].set_ylabel("LMM -log10 p")
        if "lambda_gc_lmm" in summary:
            axes[1].hist(summary["lambda_gc_lmm"].dropna(), bins=20,
                         alpha=0.6, label="LMM")
            if "lambda_gc_ols" in summary:
                axes[1].hist(summary["lambda_gc_ols"].dropna(), bins=20,
                             alpha=0.6, label="OLS")
            axes[1].axvline(1.0, color="k", lw=0.8)
            axes[1].set_xlabel("lambda_GC")
            axes[1].legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "comparison.png"), dpi=100)
        plt.close(fig)
    except Exception as e:  # the figure is optional; the table is written
        print(f"summary plot skipped: {e}", file=sys.stderr)
    return summary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--p", type=int, default=5000)
    ap.add_argument("--genes", type=int, default=8)
    ap.add_argument("--grid", action="store_true",
                    help="grid-search lambda init (reference benchmark mode)")
    ap.add_argument("--out-dir", default="eqtl_output")
    ap.add_argument("--pheno-tsv", default=None,
                    help="GD449-style TSV (IID + phenotype columns) used as "
                         "the gene expression matrix")
    ap.add_argument("--traw", default=None,
                    help="PLINK .traw genotype file (reference 1000G ingest)")
    ap.add_argument("--gemma-compare", action="store_true",
                    help="cross-check each gene against the GEMMA binary "
                         "(skipped when it is not installed)")
    ap.add_argument("--summary", action="store_true",
                    help="aggregate per-gene outputs after scanning")
    ap.add_argument("--summary-only", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    if args.summary_only:
        df = summarize(args.out_dir)
        print(df.to_string(index=False))
        return

    import torch

    from pygemma_tpu_torch import compare, pygemma
    from pygemma_tpu_torch.core.eigen import auto_eigendecompose, rotate
    from pygemma_tpu_torch.linreg import linreg
    from pygemma_tpu_torch.sim import simulate_gwas

    os.makedirs(args.out_dir, exist_ok=True)

    # --- gene expression matrix -----------------------------------------
    if args.pheno_tsv:
        genes, _iids = _load_genes_from_tsv(args.pheno_tsv)
        args.n = len(next(iter(genes.values())))
    else:
        genes = None

    # --- genotypes + kinship --------------------------------------------
    if args.traw:
        from pygemma_tpu_torch.io.traw import read_traw

        d_tr = read_traw(args.traw)
        X = np.nan_to_num(d_tr.X)
        X = (X - X.mean(0)) / np.maximum(X.std(0), 1e-6)
        n, p = X.shape
        W = np.ones((n, 1), np.float32)
        K = (X @ X.T / p + 1e-3 * np.eye(n)).astype(np.float32)
    else:
        base = simulate_gwas(n=args.n, p=args.p, seed=1000)
        X, W, K = base.X, base.W, base.K
        n, p = X.shape

    if genes is None:
        rngs = np.random.default_rng(7)
        genes = {}
        for g in range(args.genes):
            w = rngs.normal(size=p) * (rngs.random(p) < 0.002)
            genes[f"gene{g}"] = (X @ w
                                 + 0.5 * rngs.normal(size=n)).astype(np.float32)

    # shared kinship + eigendecomposition, computed once (run_pyGEMMA.sh:22)
    ev, U = auto_eigendecompose(K, "auto", np.float32, device=args.device)

    def on_device(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(U.device)

    Xr = rotate(U, on_device(X)).cpu().numpy()
    Wr = rotate(U, on_device(W)).cpu().numpy()
    ev = ev.cpu().numpy()

    task_id = int(os.environ.get("TASK_ID", 0))
    task_count = int(os.environ.get("TASK_COUNT", 1))
    names = sorted(genes)[task_id::task_count]

    for gene in names:
        y = np.asarray(genes[gene], np.float32)
        yr = rotate(U, on_device(y)).cpu().numpy()
        t0 = time.time()
        lmm = pygemma(yr, Xr, Wr, ev, eigen=False, grid=args.grid,
                      device=args.device)
        ols = linreg(y, X, W, device=args.device)
        out = os.path.join(args.out_dir, gene)
        os.makedirs(out, exist_ok=True)
        lmm.to_csv(os.path.join(out, "lmm.tsv"), sep="\t", index=False)
        ols.to_csv(os.path.join(out, "linreg.tsv"), sep="\t", index=False)
        msg = (f"{gene}: {time.time()-t0:.1f}s "
               f"min p_lmm={np.nanmin(lmm['p_wald']):.2e} "
               f"min p_ols={np.nanmin(ols['p_wald']):.2e}")
        if args.gemma_compare:
            gem = compare.run_gemma(y, X, W, K,
                                    workdir=os.path.join(out, "gemma_wd"))
            if gem is None:
                msg += " | gemma: not installed (skipped)"
            else:
                gem.to_csv(os.path.join(out, "gemma.tsv"), sep="\t",
                           index=False)
                stats = compare.compare_pvalues(lmm, gem)
                with open(os.path.join(out, "gemma_agreement.json"),
                          "w") as f:
                    json.dump(stats, f)
                msg += f" | gemma max|dlog10p|={stats['max_abs_dlog10p']:.2e}"
        print(msg, flush=True)

    if args.summary:
        summarize(args.out_dir)


if __name__ == "__main__":
    main()
