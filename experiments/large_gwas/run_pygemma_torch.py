"""Large-GWAS pipeline on PyTorch (``pygemma_tpu_torch``): externally
eigendecomposed kinship, pre-rotated data.

The same flags, inputs and output as ``run_pygemma.py`` beside it (reference
experiments/large_gwas/run_pygemma.py): raw float32 binary
genotype/phenotype/covariate matrices with .dim sidecars, an eigenvalue
file, and ``eigen=False`` so the engine skips both the eigendecomposition
and the rotation.  ``--in-program-eigh`` takes UNrotated inputs and runs the
eigendecomposition in the program instead: the implicit low-rank path with
``--lowrank-snps N``, else the dense eigh picked by ``eigh_backend``.

Runs on ``--device`` (the card by default).  ``--mesh N`` shards the scan
over SNPs, one process per card, and joins the launcher's group:

    torchrun --nproc-per-node N experiments/large_gwas/run_pygemma_torch.py \\
        --mesh N --geno G --pheno Y --eigenvalues E --out out.txt

Every rank computes the same table; rank 0 alone writes ``--out``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def _mesh(n: int, device: str):
    """A mesh of ``n`` ranks along ``snp`` over the launcher's group."""
    import torch.distributed as dist

    from pygemma_tpu_torch.parallel import distributed
    from pygemma_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(device=device)
    world = dist.get_world_size()
    if world != n:
        script = os.path.relpath(os.path.abspath(__file__))
        raise SystemExit(
            f"--mesh {n} needs a world of {n} ranks, not {world}: launch it "
            f"as torchrun --nproc-per-node {n} {script} --mesh {n} ...")
    return make_mesh(snp=n, device=device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--geno", required=True, help="rawbin prefix (rotated X, "
                    "or UNrotated with --in-program-eigh)")
    ap.add_argument("--pheno", required=True, help="rawbin prefix (rotated y)")
    ap.add_argument("--covar", help="rawbin prefix (rotated W)")
    ap.add_argument("--eigenvalues",
                    help="external eigenvalue file; omit with "
                         "--in-program-eigh")
    ap.add_argument("--in-program-eigh", action="store_true",
                    help="run the eigendecomposition in-program on UNrotated "
                         "inputs instead of consuming external eigenvalues")
    ap.add_argument("--kinship", help="rawbin prefix of a dense kinship for "
                    "--in-program-eigh; default builds the GRM from --geno")
    ap.add_argument("--lowrank-snps", type=int, default=0,
                    help="with --in-program-eigh and no --kinship: build an "
                         "implicit low-rank GRM from the first N genotype "
                         "columns (must be < n samples); 0 = dense GRM")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the scan over N ranks (launch with torchrun)")
    ap.add_argument("--out", default="output.txt")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    from pygemma_tpu_torch import pygemma
    from pygemma_tpu_torch.io import rawbin
    from pygemma_tpu_torch.parallel.mesh import is_writer

    X = np.asarray(rawbin.read_rawbin(args.geno))
    y = np.asarray(rawbin.read_rawbin(args.pheno)).reshape(-1)
    W = np.asarray(rawbin.read_rawbin(args.covar)) if args.covar else None

    if args.in_program_eigh:
        if args.kinship:
            K = np.asarray(rawbin.read_rawbin(args.kinship))
        elif args.lowrank_snps:
            from pygemma_tpu_torch import LowRankKinship

            K = LowRankKinship(X[:, : args.lowrank_snps], eps=1e-3)
        else:
            from pygemma_tpu_torch.io.kinship import kinship_blocked

            K = kinship_blocked(X, device=args.device)
        eigen = True
    else:
        if not args.eigenvalues:
            raise SystemExit(
                "--eigenvalues required (or pass --in-program-eigh)")
        K = rawbin.read_eigenvalues(args.eigenvalues)
        eigen = False

    mesh = _mesh(args.mesh, args.device) if args.mesh else None
    try:
        t0 = time.time()
        with np.errstate(over="ignore"):  # reference :56
            df = pygemma(y, X, W, K, eigen=eigen, grid=args.grid, verbose=1,
                         mesh=mesh, device=args.device)
        if is_writer(mesh):
            print(f"{X.shape[1]} SNPs in {time.time()-t0:.1f}s",
                  file=sys.stderr)
            df.to_csv(args.out, sep="\t", index=False)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
