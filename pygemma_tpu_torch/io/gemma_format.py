"""GEMMA ``.assoc.txt`` output writer.

The reference ecosystem consumes GEMMA's association table layout
(reference tests/gemma_utils.py:48 parses ``output.assoc.txt``;
reference experiments/1000G/plot_gemma.py:11 reads the
``p_wald p_lrt p_score`` columns of ``-lmm 4`` output).  Migrating
pipelines can keep their downstream parsers by exporting the
:func:`pygemma_tpu_torch.pygemma` DataFrame in the same schema:

    chr rs ps n_miss allele1 allele0 af beta se logl_H1 l_remle l_mle
    p_wald p_lrt p_score

Columns the engine does not compute for a run (e.g. ``p_lrt`` when only
Wald was requested) are filled with GEMMA's own "not computed"
placeholder (-9, as GEMMA emits for skipped tests); genotype metadata
(alleles, allele frequency, missingness) comes from the optional
arguments, defaulting to the -9 / NA placeholders -- ``n_miss`` included:
the engine does not count missing genotypes, so 0 would be a false count.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

#: GEMMA's placeholder for a value that was not computed
NOT_COMPUTED = -9


def write_gemma_assoc(
    df,
    path: str,
    chrom: Optional[Sequence] = None,
    pos: Optional[Sequence] = None,
    allele1: Optional[Sequence[str]] = None,
    allele0: Optional[Sequence[str]] = None,
    af: Optional[Sequence[float]] = None,
    n_miss: Optional[Sequence[int]] = None,
) -> None:
    """Write the association DataFrame as a GEMMA ``.assoc.txt`` table.

    ``df``: output of :func:`pygemma_tpu_torch.pygemma` (one phenotype;
    slice a multi-phenotype result by its ``pheno`` column first).
    """
    if "pheno" in getattr(df, "columns", []) and df["pheno"].nunique() > 1:
        raise ValueError(
            "multi-phenotype table: slice one pheno before exporting")
    p = len(df)

    def _col(name, default):
        if name in df.columns:
            return np.asarray(df[name])
        return np.full(p, default)

    def _opt(arr, default):
        if arr is None:
            return np.full(p, default)
        arr = np.asarray(arr)
        if len(arr) != p:
            raise ValueError(f"metadata length {len(arr)} != {p} rows")
        return arr

    rs = (np.asarray(df["SNPs"]).astype(str) if "SNPs" in df.columns
          else np.array([f"snp{i}" for i in range(p)]))
    chrom = _opt(chrom if chrom is not None
                 else (df["chrom"] if "chrom" in df.columns else None),
                 NOT_COMPUTED)
    pos = _opt(pos if pos is not None
               else (df["pos"] if "pos" in df.columns else None),
               NOT_COMPUTED)

    cols = {
        "chr": chrom,
        "rs": rs,
        "ps": pos,
        "n_miss": _opt(n_miss, NOT_COMPUTED),
        "allele1": _opt(allele1, "NA"),
        "allele0": _opt(allele0, "NA"),
        "af": _opt(af, NOT_COMPUTED),
        "beta": _col("beta", np.nan),
        "se": _col("se_beta", np.nan),
        "logl_H1": _col("logl_H1", NOT_COMPUTED),
        "l_remle": _col("lambda", np.nan),
        "l_mle": _col("lambda_ml", NOT_COMPUTED),
        "p_wald": _col("p_wald", NOT_COMPUTED),
        "p_lrt": _col("p_lrt", NOT_COMPUTED),
        "p_score": _col("p_score", NOT_COMPUTED),
    }
    with open(path, "w") as fh:
        fh.write("\t".join(cols.keys()) + "\n")
        for i in range(p):
            row = []
            for v in cols.values():
                x = v[i]
                if isinstance(x, (float, np.floating)):
                    row.append("nan" if np.isnan(x) else f"{x:.6e}")
                else:
                    row.append(str(x))
            fh.write("\t".join(row) + "\n")
