"""The port's command line and the modules behind it against the JAX
package: the .bed reader (native and NumPy), BIMBAM/traw readers and
writers, the GEMMA writer, the kinship builders, linreg, preprocess,
plotting, and ``python -m pygemma_tpu_torch run`` on the CPU against
``python -m pygemma_tpu run`` on the same files.

The reference writes ``n_miss`` as 0 in its GEMMA output
(pygemma_tpu/io/gemma_format.py:71), a count it never made; the port
writes GEMMA's -9 placeholder, held here to a hand-built expectation.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import pygemma_tpu as pj
import pygemma_tpu.__main__ as jcli
import pygemma_tpu_torch as pt
import pygemma_tpu_torch.__main__ as tcli
from pygemma_tpu.io import bimbam as jbimbam
from pygemma_tpu.io import kinship as jkin
from pygemma_tpu.io import plink as jplink
from pygemma_tpu.io import traw as jtraw
from pygemma_tpu_torch.io import bimbam, gemma_format, kinship, plink, traw
from pygemma_tpu_torch.native import bed_native
from test_torch_api import _compare

torch.set_num_threads(2)

CPU = "cpu"


def _dosages(rng, n, p, miss=0.05):
    X = rng.integers(0, 3, size=(n, p)).astype(np.float32)
    X[rng.random((n, p)) < miss] = np.nan
    return X


@pytest.mark.parametrize("count_a1", [True, False])
def test_read_bed_native_numpy_and_jax_agree(tmp_path, count_a1):
    """n = 37 and p = 150 cross the decoder's 64-SNP tiles unevenly; missing
    codes decode to NaN; a subset keeps its order."""
    rng = np.random.default_rng(5)
    X = _dosages(rng, 37, 150, miss=0.1)
    prefix = str(tmp_path / "g")
    plink.write_bed(prefix, X)
    ref = jplink.read_bed(prefix, count_a1=count_a1, use_native=False)
    for idx in (None, [149, 3, 64, 65, 0, 3]):
        nat = plink.read_bed(prefix, snp_indices=idx, count_a1=count_a1)
        npy = plink.read_bed(prefix, snp_indices=idx, count_a1=count_a1,
                             use_native=False)
        cols = slice(None) if idx is None else idx
        np.testing.assert_array_equal(nat.X, npy.X)
        np.testing.assert_array_equal(nat.X, ref.X[:, cols])
        ids = range(150) if idx is None else idx
        assert nat.snp_ids == npy.snp_ids == [ref.snp_ids[i] for i in ids]
        np.testing.assert_array_equal(nat.pos, ref.pos[cols])
        assert nat.sample_ids == ref.sample_ids
    if count_a1:
        np.testing.assert_array_equal(nat.X[:, 0], X[:, 149])


def test_read_bed_refuses_bad_input(tmp_path, monkeypatch):
    prefix = str(tmp_path / "g")
    plink.write_bed(prefix, np.zeros((5, 3), np.float32))
    with pytest.raises(IndexError):
        plink.read_bed(prefix, snp_indices=[3])

    # a failed build raises with the compiler's output: no silent fallback
    def broken_build():
        raise RuntimeError("g++ failed (1) building bed_reader.cpp:\nboom")

    monkeypatch.setattr(bed_native, "_lib", None)
    monkeypatch.setattr(bed_native, "build", broken_build)
    with pytest.raises(RuntimeError, match="boom"):
        plink.read_bed(prefix)
    assert plink.read_bed(prefix, use_native=False).X.shape == (5, 3)


def test_bed_native_builds_in_the_build_dir():
    path = bed_native.build()
    assert path.parent == bed_native.BUILD_DIR
    assert path.name.startswith("libbed_reader_") and path.exists()


def test_bimbam_roundtrip_against_jax(tmp_path):
    rng = np.random.default_rng(6)
    X = _dosages(rng, 20, 7)
    names = [f"rs{i}" for i in range(7)]
    bimbam.write_geno(str(tmp_path / "g.txt"), X, names)
    jbimbam.write_geno(str(tmp_path / "gj.txt"), X, names)
    assert (tmp_path / "g.txt").read_bytes() == (tmp_path / "gj.txt").read_bytes()
    X2, n2 = bimbam.read_geno(str(tmp_path / "g.txt"))
    Xj, nj = jbimbam.read_geno(str(tmp_path / "g.txt"))
    np.testing.assert_array_equal(X2, Xj)
    assert n2 == nj == names
    y = rng.normal(size=15).astype(np.float32)
    y[3] = np.nan
    bimbam.write_pheno(str(tmp_path / "p.txt.gz"), y)
    np.testing.assert_array_equal(
        bimbam.read_pheno(str(tmp_path / "p.txt.gz")),
        jbimbam.read_pheno(str(tmp_path / "p.txt.gz")))
    M = rng.normal(size=(10, 3)).astype(np.float32)
    bimbam.write_matrix(str(tmp_path / "m.txt"), M)
    np.testing.assert_array_equal(bimbam.read_matrix(str(tmp_path / "m.txt")),
                                  jbimbam.read_matrix(str(tmp_path / "m.txt")))


def test_traw_and_csv_against_jax(tmp_path):
    rng = np.random.default_rng(7)
    n, p = 8, 5
    X = _dosages(rng, n, p, miss=0.1)
    path = str(tmp_path / "g.traw")
    with open(path, "w") as f:
        samples = [f"F{i}_I{i}" for i in range(n)]
        f.write("CHR\tSNP\t(C)M\tPOS\tCOUNTED\tALT\t" + "\t".join(samples)
                + "\n")
        for j in range(p):
            vals = "\t".join("NA" if np.isnan(v) else str(v) for v in X[:, j])
            f.write(f"1\trs{j}\t0\t{j + 1}\tA\tT\t{vals}\n")
    got, ref = traw.read_traw(path), jtraw.read_traw(path)
    np.testing.assert_array_equal(got.X, ref.X)
    np.testing.assert_array_equal(got.X, X)
    assert got.snp_ids == ref.snp_ids and got.sample_ids == ref.sample_ids
    np.testing.assert_array_equal(got.chrom, ref.chrom)
    np.testing.assert_array_equal(got.pos, ref.pos)
    csv = str(tmp_path / "g.csv")
    pd.DataFrame(X, columns=[f"s{j}" for j in range(p)]).to_csv(csv,
                                                                index=False)
    for axis in ("rows", "cols"):
        a, na = traw.read_csv_genotypes(csv, sample_axis=axis)
        b, nb = jtraw.read_csv_genotypes(csv, sample_axis=axis)
        np.testing.assert_array_equal(a, b)
        assert na == nb


@pytest.mark.parametrize("standardize", [False, True])
def test_kinship_blocked_matches_jax(standardize):
    """Blocks of 7 over 30 SNPs (odd, ragged) against the JAX function and
    the direct builders; float32 sums in another order."""
    rng = np.random.default_rng(8)
    X = rng.normal(size=(40, 30)).astype(np.float32)
    got = kinship.kinship_blocked(X, block=7, standardize=standardize,
                                  device=CPU)
    ref = jkin.kinship_blocked(X, block=7, standardize=standardize)
    assert got.dtype == np.float32 and got.shape == (40, 40)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    direct = (kinship.standardized_kinship if standardize
              else kinship.centered_kinship)(X, device=CPU)
    jdirect = (jkin.standardized_kinship if standardize
               else jkin.centered_kinship)(X)
    np.testing.assert_allclose(direct.numpy(), np.asarray(jdirect),
                               rtol=1e-5, atol=1e-6)


def test_gcta_grm_roundtrip_against_jax(tmp_path):
    K = np.random.default_rng(9).normal(size=(6, 6)).astype(np.float32)
    K = K @ K.T
    kinship.write_gcta_grm(str(tmp_path / "a"), K, n_snps=12)
    jkin.write_gcta_grm(str(tmp_path / "b"), K, n_snps=12)
    for ext in (".grm.bin", ".grm.N.bin", ".grm.id"):
        assert (tmp_path / ("a" + ext)).read_bytes() == \
            (tmp_path / ("b" + ext)).read_bytes()
    np.testing.assert_array_equal(kinship.read_gcta_grm(str(tmp_path / "a")),
                                  jkin.read_gcta_grm(str(tmp_path / "a")))


def test_linreg_matches_jax():
    rng = np.random.default_rng(10)
    n, p = 90, 25
    X = rng.normal(size=(n, p)).astype(np.float32)
    W = np.c_[np.ones(n), rng.normal(size=(n, 2))].astype(np.float32)
    y = (X[:, 4] + rng.normal(size=n)).astype(np.float32)
    names = [f"rs{i}" for i in range(p)]
    got = pt.linreg.linreg(y, X, W, snps=names, device=CPU)
    ref = pj.linreg.linreg(y, X, W, snps=names)
    assert list(got.columns) == list(ref.columns)
    for col in ("beta", "se_beta", "t"):
        np.testing.assert_allclose(got[col], ref[col], rtol=2e-4, atol=1e-6)
    d = np.abs(np.log10(got["p_wald"]) - np.log10(ref["p_wald"]))
    assert d.max() < 0.05
    assert (got["SNPs"] == ref["SNPs"]).all()
    assert int(got["p_wald"].idxmin()) == 4


@pytest.mark.parametrize("fn", ["mean_impute", "standardize",
                                "drop_zero_variance", "quantile_normalize",
                                "pca_covariates", "genomic_control_lambda"])
def test_preprocess_matches_jax(fn):
    rng = np.random.default_rng(11)
    X = _dosages(rng, 50, 10, miss=0.2)
    Xi = pj.preprocess.mean_impute(X)
    Xi[:, 5] = 2.0
    args = {
        "mean_impute": (X,),
        "standardize": (Xi, 1e-6),
        "drop_zero_variance": (Xi, [f"rs{i}" for i in range(10)]),
        "quantile_normalize": (rng.normal(size=50) ** 3,),
        "pca_covariates": (Xi, 3),
        "genomic_control_lambda": (rng.uniform(size=1000),),
    }[fn]
    got = getattr(pt.preprocess, fn)(*args)
    ref = getattr(pj.preprocess, fn)(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        if isinstance(b, list):
            assert a == b
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_plotting(tmp_path):
    rng = np.random.default_rng(12)
    df = pd.DataFrame({"p_wald": rng.uniform(size=200),
                       "chrom": np.repeat([1, 2], 100),
                       "pos": np.tile(np.arange(100), 2)})
    assoc = str(tmp_path / "a.tsv")
    df.to_csv(assoc, sep="\t", index=False)
    tcli.main(["plot", "--assoc", assoc, "--manhattan",
               str(tmp_path / "mh.png"), "--qq", str(tmp_path / "qq.png")])
    assert (tmp_path / "mh.png").stat().st_size > 0
    assert (tmp_path / "qq.png").stat().st_size > 0
    ax = pt.plotting.manhattan_plot(df, scale="linear", cutoff=0.01,
                                    save_path=str(tmp_path / "lin.png"))
    assert ax is not None and (tmp_path / "lin.png").exists()


def test_gemma_writer_n_miss_is_not_computed(tmp_path):
    """The hand-built expectation: the placeholder -9 wherever the engine
    computed nothing, ``n_miss`` included; metadata given is written."""
    df = pd.DataFrame({"beta": [0.5, np.nan], "se_beta": [0.1, np.nan],
                       "lambda": [1.0, np.nan], "p_wald": [1e-3, np.nan],
                       "SNPs": ["rsA", "rsB"]})
    out = str(tmp_path / "a.assoc.txt")
    gemma_format.write_gemma_assoc(df, out)
    lines = open(out).read().splitlines()
    assert lines[0].split("\t") == [
        "chr", "rs", "ps", "n_miss", "allele1", "allele0", "af", "beta",
        "se", "logl_H1", "l_remle", "l_mle", "p_wald", "p_lrt", "p_score"]
    assert lines[1].split("\t") == [
        "-9", "rsA", "-9", "-9", "NA", "NA", "-9", "5.000000e-01",
        "1.000000e-01", "-9", "1.000000e+00", "-9", "1.000000e-03", "-9",
        "-9"]
    assert lines[2].split("\t")[7:] == ["nan", "nan", "-9", "nan", "-9",
                                        "nan", "-9", "-9"]
    gemma_format.write_gemma_assoc(df, out, chrom=[1, 2], pos=[10, 20],
                                   n_miss=[0, 3], af=[0.25, 0.5])
    row = open(out).read().splitlines()[2].split("\t")
    assert row[:7] == ["2", "rsB", "20", "3", "NA", "NA", "5.000000e-01"]
    multi = pd.concat([df.assign(pheno=0), df.assign(pheno=1)])
    with pytest.raises(ValueError, match="multi-phenotype"):
        gemma_format.write_gemma_assoc(multi, out)


def _cohort(tmp_path, seed, n, p, causal=None, missing=()):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 3, size=(n, p)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    if causal is not None:
        y = (y + X[:, causal]).astype(np.float32)
    y[list(missing)] = np.nan
    prefix = str(tmp_path / "d")
    plink.write_bed(prefix, X)
    bimbam.write_pheno(str(tmp_path / "ph.txt"), y)
    return prefix, str(tmp_path / "ph.txt")


def _both(tmp_path, args, out="out.tsv", gemma=False):
    """Run both CLIs on the same arguments; returns (port, jax) tables."""
    tab = []
    for name, main, extra in (("t", tcli.main, ["--device", "cpu"]),
                              ("j", jcli.main, [])):
        path = str(tmp_path / f"{name}_{out}")
        main(["run", *args, "--out", path, "--verbose", "0", *extra])
        tab.append(pd.read_csv(path, sep="\t"))
    return tab


def test_cli_gemma_export_matches_jax(tmp_path):
    """tests/test_extras.py::test_gemma_assoc_export on both CLIs."""
    prefix, ph = _cohort(tmp_path, 23, 50, 10, causal=1)
    common = ["--bfile", prefix, "--pheno", ph, "--out-format", "gemma"]
    got, ref = _both(tmp_path, common + ["--tests", "wald,lrt,score"],
                     out="a.assoc.txt")
    assert list(got.columns) == list(ref.columns)
    assert (got["n_miss"] == -9).all()  # the reference writes 0
    assert (ref["n_miss"] == 0).all()
    for col in ("chr", "rs", "ps", "allele1", "allele0", "af"):
        np.testing.assert_array_equal(got[col], ref[col])
    _compare(got.drop(columns=["n_miss"]), ref.drop(columns=["n_miss"]),
             "float32")
    assert int(got["p_wald"].idxmin()) == 1
    np.testing.assert_allclose(got["beta"], ref["beta"], rtol=2e-3,
                               atol=1e-5)
    got, ref = _both(tmp_path, common, out="w.assoc.txt")
    assert (got["p_lrt"] == -9).all() and (got["logl_H1"] == -9).all()
    _compare(got.drop(columns=["n_miss"]), ref.drop(columns=["n_miss"]),
             "float32")


def test_cli_stream_packed_lowrank_matches_jax(tmp_path):
    """tests/test_extras.py::test_cli_stream_packed_lowrank_mesh without
    --mesh: --stream-packed with --lowrank-snps against the JAX CLI, and
    against the port's own dense-ingest run."""
    prefix, ph = _cohort(tmp_path, 11, 60, 16, causal=2)
    common = ["--bfile", prefix, "--pheno", ph, "--lowrank-snps", "8"]
    got, ref = _both(tmp_path, common + ["--stream-packed"], out="s.tsv")
    _compare(got, ref, "float32")
    np.testing.assert_allclose(got["beta"], ref["beta"], rtol=2e-3,
                               atol=1e-5)
    assert got["p_wald"].idxmin() == 2
    dense = str(tmp_path / "dense.tsv")
    tcli.main(["run", *common, "--out", dense, "--device", "cpu"])
    dd = pd.read_csv(dense, sep="\t")
    np.testing.assert_allclose(got["beta"], dd["beta"], rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(np.log10(got["p_wald"]),
                               np.log10(dd["p_wald"]), atol=5e-3)


def test_cli_drops_missing_phenotype_like_jax(tmp_path):
    prefix, ph = _cohort(tmp_path, 7, 50, 12, missing=(3, 9))
    got, ref = _both(tmp_path, ["--bfile", prefix, "--pheno", ph,
                                "--drop-constant"])
    _compare(got, ref, "float32")
    assert len(got) <= 12 and np.isfinite(got["p_wald"]).mean() > 0.8


def test_cli_multi_phenotype_covariates_and_pcs(tmp_path):
    """A 4-column phenotype table (the batched scan), a covariate file with
    --add-intercept, two PCs and --qnorm: the same table as the JAX CLI."""
    rng = np.random.default_rng(13)
    n, p = 64, 20
    prefix, _ = _cohort(tmp_path, 13, n, p)
    Y = rng.normal(size=(n, 4)).astype(np.float32)
    ph = str(tmp_path / "ph.tsv")
    pd.DataFrame(Y, columns=list("abcd")).to_csv(ph, sep="\t", index=False)
    cov = str(tmp_path / "cov.txt")
    bimbam.write_matrix(cov, rng.normal(size=(n, 2)).astype(np.float32))
    got, ref = _both(tmp_path, ["--bfile", prefix, "--pheno", ph, "--covar",
                                cov, "--pcs", "2", "--qnorm"])
    assert len(got) == 4 * p
    _compare(got, ref, "float32")


def test_cli_mesh_and_device(tmp_path, monkeypatch, capfd):
    """--mesh 2 --device cpu starts two gloo ranks (processes) on this host
    and matches ``python -m pygemma_tpu --mesh 2``; only rank 0 logs, and
    the last stderr line is the parent's summary."""
    prefix, ph = _cohort(tmp_path, 3, 40, 21, causal=4)
    common = ["--bfile", prefix, "--pheno", ph, "--mesh", "2",
              "--snp-block", "8", "--tests", "wald,lrt"]
    out = str(tmp_path / "t.tsv")
    capfd.readouterr()
    tcli.main(["run", *common, "--out", out, "--device", "cpu"])
    err = capfd.readouterr().err.strip().splitlines()
    assert err[-1].startswith(f"wrote {out} (21 rows)")
    # CPU: both kernels' plain versions
    assert "fused Gram kernel launches 0; REML kernel launches 0" in err[-1]
    assert sum(line.startswith("association scan") for line in err) == 1
    jcli.main(["run", *common, "--out", str(tmp_path / "j.tsv"),
               "--verbose", "0"])
    got, ref = (pd.read_csv(tmp_path / f, sep="\t") for f in ("t.tsv",
                                                            "j.tsv"))
    _compare(got, ref, "float32")
    assert len(got) == 21 and got["p_wald"].idxmin() == 4
    args = ["run", "--bfile", prefix, "--pheno", ph, "--out",
            str(tmp_path / "o.tsv")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(args)  # the default device is the card
    assert not os.path.exists(tmp_path / "o.tsv")
