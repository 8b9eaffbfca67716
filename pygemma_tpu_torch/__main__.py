"""Command-line GWAS runner: ``python -m pygemma_tpu_torch run ...``.

Replaces the reference's per-experiment argparse drivers (e.g.
experiments/1000G/run_snp.py:22-32, experiments/large_gwas/run_pygemma.py:23-31)
with one CLI covering every ingest format, plus a ``plot`` subcommand.  The
flags are ``python -m pygemma_tpu``'s, plus ``--device`` (``cuda``, the
default, or ``cpu``); without a card the default raises instead of falling
back.

``--mesh N`` shards the scan over N ranks of a ``torch.distributed`` group,
one process each (``parallel/``).  Started by a launcher (``torchrun
--nproc-per-node N``, or srun: ``RANK`` is set) the process joins that
group; otherwise it starts the N ranks itself on this host.  Every rank
reads the inputs; rank 0 logs and writes the output.

With ``--verbose 1`` (the default) every stage ends with a line
``<stage> - <seconds> s`` on stderr, and the last line on stderr reports the
rows written, lambda_GC and the launches of the fused Gram kernel and of
the REML kernel (summed over the ranks under ``--mesh``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _load_genotypes_packed(args):
    """Production-scale ingest: wrap the on-disk 2-bit codes as a
    :class:`pygemma_tpu_torch.io.packed.PackedMatrix` (memmap; bytes ship to
    the device verbatim and decode there) instead of materializing the dense
    float32 matrix (20 GB host RAM at 50k x 100k).  Mirrors the shell
    reachability of the reference's large-GWAS flow
    (reference experiments/large_gwas/run_pygemma.py:23-31)."""
    from .io.packed import PackedMatrix

    if args.bfile:
        from .io.plink import _read_tsv

        X = PackedMatrix.open_bed(args.bfile,
                                  standardize=args.stream_standardize)
        bim = _read_tsv(args.bfile + ".bim")
        names = [r[1] for r in bim]
        chrom = np.asarray([r[0] for r in bim])
        pos = np.asarray([int(r[3]) for r in bim], dtype=np.int64)
        return X, names, chrom, pos
    if args.geno_2b:
        X = PackedMatrix.open_rawbin(args.geno_2b)
        return X, [f"snp{i}" for i in range(X.shape[1])], None, None
    raise SystemExit("--stream-packed requires --bfile or --geno-2b")


def _load_genotypes(args):
    from . import io as pio

    if args.bfile:
        d = pio.read_bed(args.bfile)
        return d.X, list(d.snp_ids), d.chrom, d.pos
    if args.traw:
        d = pio.read_traw(args.traw)
        return d.X, list(d.snp_ids), d.chrom, d.pos
    if args.geno_bimbam:
        X, names = pio.bimbam.read_geno(args.geno_bimbam)
        return X, names, None, None
    if args.geno_bin:
        X = np.asarray(pio.read_rawbin(args.geno_bin))
        return X, [f"snp{i}" for i in range(X.shape[1])], None, None
    raise SystemExit("one of --bfile/--traw/--geno-bimbam/--geno-bin required")


def _read_phenotypes(args):
    from .io import bimbam

    if args.pheno.endswith((".tsv", ".csv")):
        import pandas as pd

        ph = pd.read_csv(args.pheno, sep=None, engine="python")
        Y = ph.select_dtypes("number").to_numpy(dtype=np.float32)
        if args.pheno_col is not None:
            Y = Y[:, [args.pheno_col]]
        return Y
    return bimbam.read_pheno(args.pheno)


def _run_rank(argv, summary) -> None:
    """One rank of a ``--mesh`` run started by :func:`cmd_run`; rank 0 puts
    its summary line on ``summary`` for the parent to print last."""
    args = _parser().parse_args(argv)
    args.summary = summary
    cmd_run(args)


def cmd_run(args):
    from . import GwasConfig, pygemma
    from . import preprocess as pp
    from .device import resolve_device
    from .io import bimbam, rawbin
    from .ops.gram_kernel import fused_grams
    from .ops.reml_kernel import reml_kernel
    from .utils.logging import StageLogger

    resolve_device(args.device)
    if args.mesh and "RANK" not in os.environ:
        import importlib
        import multiprocessing

        from .parallel.distributed import spawn

        # the ranks find _run_rank by this module's import name: under
        # ``python -m`` this module is __main__, which they cannot import
        this = importlib.import_module(f"{__package__}.__main__")
        summary = multiprocessing.get_context("spawn").SimpleQueue()
        spawn(this._run_rank, args.mesh, (args.argv, summary))
        print(summary.get(), file=sys.stderr)
        return
    mesh = None
    if args.mesh:
        from .parallel.mesh import make_mesh

        mesh = make_mesh(snp=args.mesh, device=args.device)
    log = StageLogger(args.verbose)
    t_start = time.time()

    streamed = bool(args.stream_packed or args.geno_2b)
    with log.stage("read genotypes"):
        if streamed:
            X, names, chrom, pos = _load_genotypes_packed(args)
            for flag in ("drop_constant", "pcs"):
                if getattr(args, flag):
                    raise SystemExit(
                        f"--{flag.replace('_', '-')} needs the dense genotype "
                        "matrix; drop it or omit --stream-packed (a constant "
                        "SNP simply yields the NaN row contract)")
        else:
            X, names, chrom, pos = _load_genotypes(args)
            if np.isnan(X).any():
                X = pp.mean_impute(X)
            if args.drop_constant:
                X, names, keep = pp.drop_zero_variance(X, names)
                chrom = chrom[keep] if chrom is not None else None
                pos = pos[keep] if pos is not None else None

    with log.stage("read phenotypes and covariates"):
        Y = _read_phenotypes(args)
        # drop individuals with missing phenotype BEFORE any transform
        # (reference workload-layer behavior, e.g. ukb_afr/code/run_snp.py)
        y_first = Y[:, 0] if Y.ndim > 1 else Y
        keep = np.isfinite(np.asarray(y_first, dtype=np.float64))
        if not keep.all():
            if streamed:
                raise SystemExit(
                    f"{int((~keep).sum())} individuals have missing "
                    "phenotype; the packed streaming path cannot subset the "
                    "sample axis lazily -- filter the .fam/.bed upstream "
                    "(plink --keep) or omit --stream-packed")
            print(f"dropping {int((~keep).sum())} individuals with missing "
                  f"phenotype", file=sys.stderr)
            Y = Y[keep]
            X = X[keep]

        if args.qnorm:
            Y = np.column_stack(
                [pp.quantile_normalize(Y[:, i]) if Y.ndim > 1
                 else pp.quantile_normalize(Y)
                 for i in range(Y.shape[1] if Y.ndim > 1 else 1)])

        W = bimbam.read_matrix(args.covar) if args.covar else None
        if W is not None and not keep.all():
            W = np.asarray(W)[keep]
        if args.pcs:
            pcs = pp.pca_covariates(X, n_pcs=args.pcs)
            W = pcs if W is None else np.c_[W, pcs]
        if W is not None and W.ndim == 1:
            W = W[:, None]
        if W is not None and args.add_intercept:
            W = np.c_[np.ones(len(W), dtype=np.float32), W]

    eigen = True
    if args.kinship:
        K = bimbam.read_matrix(args.kinship)
    elif args.eigenvalues:
        K = rawbin.read_eigenvalues(args.eigenvalues)
        eigen = False
    elif args.lowrank_snps:
        # implicit low-rank GRM from the first N SNP columns: K = G G'/N
        # + eps I, never materialized -- the production path for large n
        # (core/lowrank.py; replaces the reference's external SLATE
        # eigendecomposition seam from the shell)
        from .core.lowrank import LowRankKinship

        n = X.shape[0]
        if args.lowrank_snps >= n:
            raise SystemExit(
                f"--lowrank-snps {args.lowrank_snps} must be < n={n} "
                "(otherwise use the dense GRM)")
        G = (X.cols(0, args.lowrank_snps) if streamed
             else X[:, : args.lowrank_snps])
        K = LowRankKinship(G, eps=args.lowrank_eps)
    else:
        from .io.kinship import kinship_blocked

        with log.stage("kinship (GRM)"):
            K = kinship_blocked(X, standardize=args.gk == 2,
                                device=args.device)

    cfg = GwasConfig(tests=tuple(args.tests.split(",")),
                     grid=args.grid, snp_block=args.snp_block)
    launches = fused_grams.launches
    reml_launches = reml_kernel.launches
    df = pygemma(Y, X, W, K, snps=names, eigen=eigen, verbose=args.verbose,
                 config=cfg, run_dir=args.run_dir, mesh=mesh,
                 device=args.device)
    launches = fused_grams.launches - launches
    reml_launches = reml_kernel.launches - reml_launches
    if mesh is not None:
        from .parallel.distributed import all_sum
        from .parallel.mesh import is_writer

        launches = all_sum(launches)
        reml_launches = all_sum(reml_launches)
        if not is_writer(mesh):
            return
    with log.stage(f"write {args.out}"):
        if chrom is not None:
            reps = len(df) // len(chrom)
            df["chrom"] = np.tile(chrom, reps)
            df["pos"] = np.tile(pos, reps)
        if args.out_format == "gemma":
            from .io.gemma_format import write_gemma_assoc

            write_gemma_assoc(df, args.out)
        else:
            df.to_csv(args.out, sep="\t", index=False)

    line = (f"wrote {args.out} ({len(df)} rows) in "
            f"{time.time() - t_start:.1f}s; "
            f"lambda_GC={pp.genomic_control_lambda(df['p_wald']):.4f}; "
            f"fused Gram kernel launches {launches}; "
            f"REML kernel launches {reml_launches}")
    if getattr(args, "summary", None) is not None:
        args.summary.put(line)
    else:
        print(line, file=sys.stderr)


def cmd_plot(args):
    import pandas as pd

    from .plotting import manhattan_plot, qq_plot

    df = pd.read_csv(args.assoc, sep="\t")
    if args.manhattan:
        manhattan_plot(df, pval_col=args.pval_col, save_path=args.manhattan)
    if args.qq:
        qq_plot(df[args.pval_col], save_path=args.qq)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pygemma_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a GWAS")
    r.add_argument("--bfile", help="PLINK prefix (.bed/.bim/.fam)")
    r.add_argument("--traw", help="PLINK .traw dosage file")
    r.add_argument("--geno-bimbam", help="BIMBAM mean-genotype file")
    r.add_argument("--geno-bin", help="raw float32 .bin/.dim prefix")
    r.add_argument("--geno-2b",
                   help="2-bit packed prefix (.2b/.dim/.scale.npz, written "
                        "by io.packed.write_rawbin_2bit); implies streaming")
    r.add_argument("--stream-packed", action="store_true",
                   help="stream 2-bit genotype codes to the device and "
                        "decode there (memmap host-side; never builds the "
                        "dense float32 matrix). Use with --bfile or "
                        "--geno-2b for production-scale cohorts")
    r.add_argument("--stream-standardize", action="store_true",
                   help="with --stream-packed: unit-variance scale each SNP "
                        "(default only centers, so beta matches the dense "
                        "dosage path)")
    r.add_argument("--lowrank-snps", type=int, default=0,
                   help="build an implicit low-rank GRM from the first N "
                        "SNPs (K = GG'/N + eps I, never materialized); the "
                        "large-n production path")
    r.add_argument("--lowrank-eps", type=float, default=1e-3,
                   help="diagonal ridge for --lowrank-snps (default 1e-3)")
    r.add_argument("--mesh", type=int, default=0,
                   help="shard the scan over N ranks, one process and one "
                        "card each (ranks may share a card): joins the "
                        "launcher's group under torchrun/srun, else starts "
                        "N ranks on this host")
    r.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="compute device (default cuda; raises without one)")
    r.add_argument("--pheno", required=True)
    r.add_argument("--pheno-col", type=int, default=None)
    r.add_argument("--covar", help="covariate matrix file")
    r.add_argument("--kinship", help="dense kinship matrix file")
    r.add_argument("--eigenvalues",
                   help="precomputed eigenvalue file (inputs pre-rotated)")
    r.add_argument("--gk", type=int, default=1, choices=(1, 2),
                   help="kinship type: 1 centered, 2 standardized")
    r.add_argument("--pcs", type=int, default=0)
    r.add_argument("--tests", default="wald")
    r.add_argument("--grid", action="store_true")
    r.add_argument("--qnorm", action="store_true")
    r.add_argument("--drop-constant", action="store_true")
    r.add_argument("--add-intercept", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="prepend an intercept column to W "
                        "(--no-add-intercept if your covariate file already "
                        "includes one, as GEMMA -c files do)")
    r.add_argument("--snp-block", type=int, default=2048)
    r.add_argument("--run-dir", help="checkpoint/resume directory")
    r.add_argument("--verbose", type=int, default=1)
    r.add_argument("--out", default="assoc.tsv")
    r.add_argument("--out-format", default="tsv", choices=("tsv", "gemma"),
                   help="'gemma' writes the GEMMA .assoc.txt schema "
                        "(chr rs ps ... p_wald p_lrt p_score) so existing "
                        "GEMMA-output parsers keep working")
    r.set_defaults(func=cmd_run)

    pl = sub.add_parser("plot", help="plot association results")
    pl.add_argument("--assoc", required=True)
    pl.add_argument("--pval-col", default="p_wald")
    pl.add_argument("--manhattan")
    pl.add_argument("--qq")
    pl.set_defaults(func=cmd_plot)
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    args.argv = argv
    args.func(args)


if __name__ == "__main__":
    main()
