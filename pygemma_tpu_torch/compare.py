"""Cross-tool oracle bridges: GEMMA, GCTA and EMMA rivals (reference L7).

Parity targets:
* GEMMA: write BIMBAM inputs, shell ``gemma -lmm``, parse output.assoc.txt
  (reference tests/gemma_utils.py:17-56).
* GCTA ``--mlma``: PLINK bed + binary GRM inputs, retry loop on GCTA's
  sporadic "Xt_Vi_X is not invertible" failures (reference
  experiments/animal_gwas/gemma_utils.py:104-160).
* EMMA: generated R script around ``emma.REML.t`` (reference
  tests/gemma_utils.py:58-161) plus :func:`emma_reml_t`, a from-scratch
  NumPy implementation of the EMMA algorithm usable as a fixture generator
  when no R/emma install exists.

Binaries are located via $GEMMA / $GCTA / $RSCRIPT or PATH; absence degrades
to None so test harnesses can skip rather than fail (the reference hardcodes
cluster paths, tests/gemma_utils.py:14).

NumPy and pandas only: the same functions as ``pygemma_tpu.compare``,
writing their inputs with this package's own ``io`` modules.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional

import numpy as np
import pandas as pd

from .io import bimbam


def find_gemma() -> Optional[str]:
    return os.environ.get("GEMMA") or shutil.which("gemma")


def run_gemma(
    Y: np.ndarray,
    X: np.ndarray,
    W: Optional[np.ndarray],
    K: np.ndarray,
    snps: Optional[List[str]] = None,
    lmm_mode: int = 1,  # 1=Wald 2=LRT 3=score 4=all (GEMMA -lmm)
    workdir: Optional[str] = None,
) -> Optional[pd.DataFrame]:
    """Run GEMMA on the given matrices; None when no binary is available."""
    binary = find_gemma()
    if binary is None:
        return None
    n, p = X.shape
    snps = snps or [f"rs{i}" for i in range(p)]
    tmp = workdir or tempfile.mkdtemp(prefix="gemma_bridge_")
    os.makedirs(tmp, exist_ok=True)
    geno = os.path.join(tmp, "geno.txt")
    pheno = os.path.join(tmp, "pheno.txt")
    kin = os.path.join(tmp, "kinship.txt")
    bimbam.write_geno(geno, X, snps)
    bimbam.write_pheno(pheno, np.asarray(Y).reshape(-1))
    bimbam.write_matrix(kin, K)
    cmd = [binary, "-g", geno, "-p", pheno, "-k", kin,
           "-lmm", str(lmm_mode), "-o", "bridge", "-outdir", tmp,
           "-notsnp", "-miss", "1", "-maf", "0", "-r2", "1"]
    if W is not None:
        covar = os.path.join(tmp, "covar.txt")
        bimbam.write_matrix(covar, W)
        cmd += ["-c", covar]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    out = os.path.join(tmp, "bridge.assoc.txt")
    if res.returncode != 0 or not os.path.exists(out):
        raise RuntimeError(f"GEMMA failed: {res.stderr[-2000:]}")
    return pd.read_csv(out, sep=r"\s+")


def find_gcta() -> Optional[str]:
    return (os.environ.get("GCTA") or shutil.which("gcta64")
            or shutil.which("gcta"))


def run_gcta(
    Y: np.ndarray,
    X: np.ndarray,
    W: Optional[np.ndarray],
    K: np.ndarray,
    snps: Optional[List[str]] = None,
    workdir: Optional[str] = None,
    max_attempts: int = 5,
    threads: int = 1,
    reml_maxit: int = 100,
) -> Optional[pd.DataFrame]:
    """Run ``gcta --mlma`` on the given matrices; None without a binary.

    Mirrors the reference's runner (experiments/animal_gwas/
    gemma_utils.py:104-160): PLINK bfile + binary GRM + FID/IID phenotype
    (and optional quantitative covariates), with a retry loop because GCTA
    "sometimes ha[s] uninvertible matrix" on some inputs.
    """
    binary = find_gcta()
    if binary is None:
        return None
    from .io.kinship import write_gcta_grm
    from .io.plink import write_bed

    n, p = X.shape
    snps = snps or [f"rs{i}" for i in range(p)]
    tmp = workdir or tempfile.mkdtemp(prefix="gcta_bridge_")
    os.makedirs(tmp, exist_ok=True)
    bfile = os.path.join(tmp, "geno")
    # GCTA decodes hard calls; round imputed dosages for the bridge
    write_bed(bfile, np.clip(np.round(np.nan_to_num(X)), 0, 2), snp_ids=snps)
    write_gcta_grm(os.path.join(tmp, "grm"), K, n_snps=p)
    with open(os.path.join(tmp, "pheno.tsv"), "w") as f:
        for i, v in enumerate(np.asarray(Y).reshape(-1)):
            f.write(f"fam{i}\tid{i}\t{v:.10g}\n")
    cmd = [binary, "--bfile", bfile, "--pheno",
           os.path.join(tmp, "pheno.tsv"), "--grm", os.path.join(tmp, "grm"),
           "--out", os.path.join(tmp, "output"), "--mlma-no-preadj-covar",
           "--thread-num", str(threads), "--mlma",
           "--reml-maxit", str(reml_maxit)]
    if W is not None and W.shape[1] > 1:
        with open(os.path.join(tmp, "covariates.tsv"), "w") as f:
            for i in range(n):
                row = "\t".join(f"{v:.10g}" for v in W[i, 1:])
                f.write(f"fam{i}\tid{i}\t{row}\n")
        cmd += ["--qcovar", os.path.join(tmp, "covariates.tsv")]
    # Retry loop (gemma_utils.py:108-131): some random SNP subsets make
    # GCTA's Xt_Vi_X singular; a failed attempt is detected on stdout.
    for attempt in range(max_attempts):
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=3600)
        text = res.stdout + res.stderr
        if ("Error: Xt_Vi_X is not invertible." not in text
                and "An error occurs, please check the options or data"
                not in text):
            break
    out = os.path.join(tmp, "output.mlma")
    if not os.path.exists(out):
        raise RuntimeError(f"GCTA failed after {max_attempts} attempts: "
                           f"{text[-2000:]}")
    df = pd.read_csv(out, sep="\t")
    return df.rename(columns={"p": "p_wald", "b": "beta", "se": "se_beta"})


def write_sparse_grm(prefix: str, K: np.ndarray, cutoff: float = 0.05,
                     sample_ids=None) -> int:
    """Write K thresholded to GCTA's sparse-GRM text format.

    fastGWA consumes a sparse GRM (``--grm-sparse``, made upstream by
    ``gcta --make-bK-sparse``; reference experiments/benchmarks/
    subsample.R:95-117): ``<prefix>.grm.sp`` holds "i j value" lines
    (0-based, j <= i) for |K_ij| >= cutoff plus all diagonals, and
    ``<prefix>.grm.id`` the FID/IID table.  Returns the entry count.
    """
    K = np.asarray(K, np.float32)
    n = K.shape[0]
    sample_ids = sample_ids or [f"id{i}" for i in range(n)]
    il, jl = np.tril_indices(n)
    vals = K[il, jl]
    keep = (np.abs(vals) >= cutoff) | (il == jl)
    with open(prefix + ".grm.sp", "w") as f:
        for i, j, v in zip(il[keep], jl[keep], vals[keep]):
            f.write(f"{i}\t{j}\t{v:.6f}\n")
    with open(prefix + ".grm.id", "w") as f:
        for i, sid in enumerate(sample_ids):
            f.write(f"fam{i}\t{sid}\n")
    return int(keep.sum())


def run_fastgwa(
    Y: np.ndarray,
    X: np.ndarray,
    W: Optional[np.ndarray],
    K: np.ndarray,
    snps: Optional[List[str]] = None,
    workdir: Optional[str] = None,
    threads: int = 1,
    sparse_cutoff: float = 0.05,
) -> Optional[pd.DataFrame]:
    """Run GCTA's fastGWA-mlm on the given matrices; None without a binary.

    The reference's headline comparisons time fastGWA as a rival
    (experiments/benchmarks/subsample.R:112-126: ``gcta --grm-sparse
    <sp_grm> --fastGWA-mlm --pheno ... [--qcovar ...]``); this bridge
    reproduces that invocation from in-memory matrices, thresholding the
    dense K into the sparse GRM fastGWA expects.  Output columns are
    normalized to (beta, se_beta, p_wald).
    """
    binary = find_gcta()
    if binary is None:
        return None
    from .io.plink import write_bed

    n, p = X.shape
    snps = snps or [f"rs{i}" for i in range(p)]
    tmp = workdir or tempfile.mkdtemp(prefix="fastgwa_bridge_")
    os.makedirs(tmp, exist_ok=True)
    bfile = os.path.join(tmp, "geno")
    write_bed(bfile, np.clip(np.round(np.nan_to_num(X)), 0, 2), snp_ids=snps)
    write_sparse_grm(os.path.join(tmp, "grm_sp"), K, cutoff=sparse_cutoff)
    with open(os.path.join(tmp, "pheno.tsv"), "w") as f:
        for i, v in enumerate(np.asarray(Y).reshape(-1)):
            f.write(f"fam{i}\tid{i}\t{v:.10g}\n")
    cmd = [binary, "--bfile", bfile, "--grm-sparse",
           os.path.join(tmp, "grm_sp"), "--fastGWA-mlm",
           "--pheno", os.path.join(tmp, "pheno.tsv"),
           "--thread-num", str(threads),
           "--out", os.path.join(tmp, "output")]
    if W is not None and W.shape[1] > 1:
        with open(os.path.join(tmp, "covariates.tsv"), "w") as f:
            for i in range(n):
                row = "\t".join(f"{v:.10g}" for v in W[i, 1:])
                f.write(f"fam{i}\tid{i}\t{row}\n")
        cmd += ["--qcovar", os.path.join(tmp, "covariates.tsv")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    out = os.path.join(tmp, "output.fastGWA")
    if not os.path.exists(out):
        raise RuntimeError(
            f"fastGWA failed: {(res.stdout + res.stderr)[-2000:]}")
    df = pd.read_csv(out, sep="\t")
    return df.rename(columns={"P": "p_wald", "BETA": "beta",
                              "SE": "se_beta"})


def find_regenie() -> Optional[str]:
    return os.environ.get("REGENIE") or shutil.which("regenie")


def run_regenie(
    Y: np.ndarray,
    X: np.ndarray,
    W: Optional[np.ndarray],
    snps: Optional[List[str]] = None,
    workdir: Optional[str] = None,
    threads: int = 1,
    bsize: int = 1000,
) -> Optional[pd.DataFrame]:
    """Run Regenie step 1 + step 2 on the given matrices; None without a
    binary.

    Mirrors the reference's two-step invocation (experiments/benchmarks/
    subsample.R regenie section: ``--step 1 --bed ... --bsize 1000 --lowmem``
    then ``--step 2 --pred <out>_pred.list``); Regenie replaces the GRM
    with step-1 whole-genome ridge predictions, so no kinship argument.
    Output columns are normalized to (beta, se_beta, p_wald).
    """
    binary = find_regenie()
    if binary is None:
        return None
    from .io.plink import write_bed

    n, p = X.shape
    snps = snps or [f"rs{i}" for i in range(p)]
    tmp = workdir or tempfile.mkdtemp(prefix="regenie_bridge_")
    os.makedirs(tmp, exist_ok=True)
    bfile = os.path.join(tmp, "geno")
    write_bed(bfile, np.clip(np.round(np.nan_to_num(X)), 0, 2), snp_ids=snps)
    with open(os.path.join(tmp, "pheno.tsv"), "w") as f:
        f.write("FID\tIID\tY1\n")
        for i, v in enumerate(np.asarray(Y).reshape(-1)):
            f.write(f"fam{i}\tid{i}\t{v:.10g}\n")
    covar_args: List[str] = []
    if W is not None and W.shape[1] > 1:
        with open(os.path.join(tmp, "covar.tsv"), "w") as f:
            f.write("FID\tIID\t" + "\t".join(
                f"V{j}" for j in range(1, W.shape[1])) + "\n")
            for i in range(n):
                row = "\t".join(f"{v:.10g}" for v in W[i, 1:])
                f.write(f"fam{i}\tid{i}\t{row}\n")
        covar_args = ["--covarFile", os.path.join(tmp, "covar.tsv")]
    out = os.path.join(tmp, "output")
    common = ["--bed", bfile, "--phenoFile", os.path.join(tmp, "pheno.tsv"),
              "--threads", str(threads), "--bsize", str(bsize)] + covar_args
    step1 = [binary, "--step", "1", *common, "--lowmem",
             "--lowmem-prefix", os.path.join(tmp, "tmp_rg"), "--out", out]
    res1 = subprocess.run(step1, capture_output=True, text=True,
                          timeout=3600)
    pred = out + "_pred.list"
    if not os.path.exists(pred):
        raise RuntimeError(
            f"regenie step 1 failed: {(res1.stdout + res1.stderr)[-2000:]}")
    step2 = [binary, "--step", "2", *common, "--pred", pred, "--out", out]
    res2 = subprocess.run(step2, capture_output=True, text=True,
                          timeout=3600)
    assoc = out + "_Y1.regenie"
    if not os.path.exists(assoc):
        raise RuntimeError(
            f"regenie step 2 failed: {(res2.stdout + res2.stderr)[-2000:]}")
    df = pd.read_csv(assoc, sep=r"\s+")
    df["p_wald"] = 10.0 ** (-df["LOG10P"].astype(float))
    return df.rename(columns={"BETA": "beta", "SE": "se_beta"})


def find_rscript() -> Optional[str]:
    return os.environ.get("RSCRIPT") or shutil.which("Rscript")


_EMMA_R = """
library(emma)
geno <- read.table("genotypes.tsv", header=FALSE, sep=",")
geno <- t(as.matrix(geno[, 4:ncol(geno)]))  # BIMBAM rows -> (p, n)
pheno <- as.matrix(read.table("phenotypes.tsv", header=FALSE))
covar <- as.matrix(read.table("covariates.tsv", header=FALSE))
kinship <- as.matrix(read.table("relatedness_matrix.tsv", header=FALSE))
output <- data.frame(emma.REML.t(t(pheno), geno, kinship, X0=covar,
                                 esp=1e-20))
colnames(output)[1] <- "p_wald"
output$p_wald[is.na(output$stat)] <- NA
write.csv(output, file="output.assoc.txt", row.names=FALSE)
"""


def run_emma(
    Y: np.ndarray,
    X: np.ndarray,
    W: Optional[np.ndarray],
    K: np.ndarray,
    snps: Optional[List[str]] = None,
    workdir: Optional[str] = None,
) -> Optional[pd.DataFrame]:
    """Run the R ``emma`` package via a generated script; None without R.

    Reference pattern: tests/gemma_utils.py:58-161 generates an inline
    ``emma.REML.t`` R script over TSV inputs.  :func:`emma_reml_t` is the
    in-process NumPy equivalent for hosts without R.
    """
    rscript = find_rscript()
    if rscript is None:
        return None
    n, p = X.shape
    tmp = workdir or tempfile.mkdtemp(prefix="emma_bridge_")
    os.makedirs(tmp, exist_ok=True)
    bimbam.write_geno(os.path.join(tmp, "genotypes.tsv"), X,
                      snps or [f"rs{i}" for i in range(p)])
    bimbam.write_pheno(os.path.join(tmp, "phenotypes.tsv"),
                       np.asarray(Y).reshape(-1))
    bimbam.write_matrix(os.path.join(tmp, "covariates.tsv"),
                        W if W is not None else np.ones((n, 1)))
    bimbam.write_matrix(os.path.join(tmp, "relatedness_matrix.tsv"), K)
    with open(os.path.join(tmp, "emma_script.R"), "w") as f:
        f.write(_EMMA_R)
    res = subprocess.run([rscript, "emma_script.R"], cwd=tmp,
                         capture_output=True, text=True, timeout=3600)
    out = os.path.join(tmp, "output.assoc.txt")
    if res.returncode != 0 or not os.path.exists(out):
        return None  # no emma package installed; treat like no binary
    return pd.read_csv(out)


def emma_reml_t(
    Y: np.ndarray,
    X: np.ndarray,
    W: Optional[np.ndarray],
    K: np.ndarray,
    n_grid: int = 100,
    lim_log10: float = 10.0,
) -> pd.DataFrame:
    """From-scratch NumPy implementation of EMMA's ``emma.REML.t``.

    EMMA (Kang et al., Genetics 2008) parameterizes the variance ratio as
    delta = sigma_e^2 / sigma_g^2 (the reciprocal of GEMMA's lambda) and
    maximizes the restricted likelihood on the spectrum of S K S, where S
    projects out the fixed effects -- a genuinely different computational
    path from both this repo's Gram/Woodbury engine and its dense-projection
    oracle, which makes it an independent cross-check fixture generator
    (stands in for the reference's R EMMA baseline,
    tests/gemma_utils.py:58-161).

    Returns a DataFrame with (beta, se_beta, stat, delta, p_wald) per SNP;
    p is the two-sided t(n - q) p-value, identical to the F(1, n-q) Wald p.
    """
    from scipy import optimize
    from scipy import stats as sps

    y = np.asarray(Y, np.float64).reshape(-1)
    X = np.asarray(X, np.float64)
    K = np.asarray(K, np.float64)
    n, p = X.shape
    W = np.ones((n, 1)) if W is None else np.asarray(W, np.float64)

    log_deltas = np.linspace(-lim_log10, lim_log10, n_grid)

    def reml_ll_parts(Xfull):
        q = Xfull.shape[1]
        # spectrum of S K S on the complement of span(Xfull)
        Qx, _ = np.linalg.qr(Xfull)
        S = np.eye(n) - Qx @ Qx.T
        ev, U = np.linalg.eigh(S @ (K + np.eye(n)) @ S)
        keep = np.argsort(ev)[q:]  # drop the q (near-)zero eigenvalues
        lam = np.maximum(ev[keep] - 1.0, -1.0 + 1e-12)  # spectrum of SKS
        eta = U[:, keep].T @ y
        return lam, eta, q

    def dll(delta, lam, eta, nq):
        """d/d(delta) of the restricted log-likelihood (x2; sign-exact)."""
        hd = lam + delta
        return nq * np.sum(eta**2 / hd**2) / np.sum(eta**2 / hd) \
            - np.sum(1.0 / hd)

    def reml_ll(delta, lam, eta, nq):
        hd = lam + delta
        rss = np.sum(eta**2 / hd)
        return 0.5 * (nq * np.log(nq / (2 * np.pi)) - nq
                      - nq * np.log(rss) - np.sum(np.log(hd)))

    rows = []
    for g in range(p):
        Xfull = np.c_[W, X[:, g]]
        q = Xfull.shape[1]
        nq = n - q
        try:
            lam, eta, q = reml_ll_parts(Xfull)
            deltas = 10.0 ** log_deltas
            d1 = np.array([dll(d, lam, eta, nq) for d in deltas])
            cands = [deltas[0], deltas[-1]]
            # refine every sign-change bracket (EMMA uses uniroot per grid
            # interval), then keep the argmax-likelihood candidate
            for i in range(len(deltas) - 1):
                if np.sign(d1[i]) * np.sign(d1[i + 1]) < 0:
                    cands.append(optimize.brentq(
                        dll, deltas[i], deltas[i + 1],
                        args=(lam, eta, nq)))
            lls = [reml_ll(d, lam, eta, nq) for d in cands]
            delta = cands[int(np.argmax(lls))]
            # GLS at the REML delta with H = K + delta I
            evK, UK = np.linalg.eigh(K + np.eye(n) * delta)
            d_inv = 1.0 / np.maximum(evK, 1e-12)
            Xr = UK.T @ Xfull
            yr = UK.T @ y
            XtHiX = Xr.T @ (d_inv[:, None] * Xr)
            XtHiX_inv = np.linalg.inv(XtHiX)
            betas = XtHiX_inv @ (Xr.T @ (d_inv * yr))
            resid = yr - Xr @ betas
            sigma_g2 = float(resid @ (d_inv * resid)) / nq
            se = np.sqrt(sigma_g2 * XtHiX_inv[q - 1, q - 1])
            stat = betas[q - 1] / se
            pval = 2.0 * sps.t.sf(abs(stat), nq)
            rows.append((betas[q - 1], se, stat, delta, pval))
        except np.linalg.LinAlgError:
            rows.append((np.nan,) * 5)
    return pd.DataFrame(
        rows, columns=["beta", "se_beta", "stat", "delta", "p_wald"]
    )


def compare_pvalues(df_ours: pd.DataFrame, df_gemma: pd.DataFrame,
                    col_ours: str = "p_wald",
                    col_gemma: str = "p_wald") -> dict:
    """Summary statistics of agreement (the reference eyeballs scatter plots,
    tests/test_pygemma.py:536-866; here: quantified)."""
    a = -np.log10(np.maximum(np.asarray(df_ours[col_ours], float), 1e-300))
    b = -np.log10(np.maximum(np.asarray(df_gemma[col_gemma], float), 1e-300))
    m = np.isfinite(a) & np.isfinite(b)
    return {
        "n": int(m.sum()),
        "max_abs_dlog10p": float(np.max(np.abs(a[m] - b[m]))) if m.any() else np.nan,
        "corr_log10p": float(np.corrcoef(a[m], b[m])[0, 1]) if m.sum() > 2 else np.nan,
    }
