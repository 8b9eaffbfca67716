"""The port's ``compare`` (cross-tool bridges, the NumPy EMMA) against
the JAX package's, on the same inputs: the bridges are driven with stub
binaries, as tests/test_extras.py drives the JAX package's, and must write
the same input files and parse the same tables."""

import numpy as np
import pandas as pd
import pytest
import torch

import oracle
from pygemma_tpu import compare as jcmp
from pygemma_tpu_torch import compare as tcmp

torch.set_num_threads(2)

_GEMMA_STUB = (
    "#!/bin/bash\n"
    "while [[ $# -gt 0 ]]; do\n"
    "  case $1 in\n"
    "    -outdir) OUT=$2; shift 2;;\n"
    "    -o) NAME=$2; shift 2;;\n"
    "    *) shift;;\n"
    "  esac\n"
    "done\n"
    "printf 'chr\\trs\\tps\\tn_miss\\tallele1\\tallele0\\taf\\tbeta\\tse"
    "\\tlogl_H1\\tl_remle\\tp_wald\\n' > $OUT/$NAME.assoc.txt\n"
    "printf -- '1\\trs0\\t1\\t0\\tA\\tT\\t0.3\\t0.5\\t0.1\\t-10\\t2.0\\t0.001\\n'"
    " >> $OUT/$NAME.assoc.txt\n"
)


def _gcta_stub(marker):
    """Fails once with GCTA's own error string, then writes a .mlma."""
    return (
        "#!/bin/bash\n"
        "while [[ $# -gt 0 ]]; do\n"
        "  case $1 in\n"
        "    --out) OUT=$2; shift 2;;\n"
        "    *) shift;;\n"
        "  esac\n"
        "done\n"
        f"if [[ ! -e {marker} ]]; then\n"
        f"  touch {marker}\n"
        "  echo 'Error: Xt_Vi_X is not invertible.'\n"
        "  exit 0\n"
        "fi\n"
        "printf 'Chr\\tSNP\\tbp\\tA1\\tA2\\tFreq\\tb\\tse\\tp\\n' > $OUT.mlma\n"
        "printf '1\\trs0\\t1\\tA\\tT\\t0.3\\t0.41\\t0.1\\t0.002\\n' >> $OUT.mlma\n"
    )


def _stub(path, text):
    path.write_text(text)
    path.chmod(0o755)
    return str(path)


def _same_files(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_gemma_bridge_with_stub_binary(tmp_path, monkeypatch):
    monkeypatch.setenv("GEMMA", _stub(tmp_path / "gemma", _GEMMA_STUB))
    rng = np.random.default_rng(1)
    args = (rng.normal(size=6), rng.normal(size=(6, 2)),
            np.c_[np.ones(6), rng.normal(size=6)], np.eye(6))
    got = tcmp.run_gemma(*args, workdir=str(tmp_path / "t"))
    ref = jcmp.run_gemma(*args, workdir=str(tmp_path / "j"))
    pd.testing.assert_frame_equal(got, ref)
    assert got["p_wald"].iloc[0] == 0.001
    _same_files(tmp_path / "t", tmp_path / "j",
                ("geno.txt", "pheno.txt", "kinship.txt", "covar.txt"))


def test_gcta_bridge_with_stub_binary(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    X = rng.integers(0, 3, size=(8, 3)).astype(np.float32)
    args = (rng.normal(size=8), X, np.c_[np.ones(8), rng.normal(size=8)],
            np.eye(8))
    tabs = []
    for name, mod in (("t", tcmp), ("j", jcmp)):
        marker = tmp_path / f"attempted_{name}"
        monkeypatch.setenv("GCTA", _stub(tmp_path / f"gcta_{name}",
                                         _gcta_stub(marker)))
        tabs.append(mod.run_gcta(*args, workdir=str(tmp_path / name)))
        assert marker.exists()  # the first, failing attempt really ran
    pd.testing.assert_frame_equal(*tabs)
    assert tabs[0]["p_wald"].iloc[0] == 0.002 and tabs[0]["beta"].iloc[0] == 0.41
    _same_files(tmp_path / "t", tmp_path / "j",
                ("geno.bed", "geno.bim", "geno.fam", "grm.grm.bin",
                 "grm.grm.id", "grm.grm.N.bin", "pheno.tsv",
                 "covariates.tsv"))


def test_sparse_grm_matches_jax(tmp_path):
    K = oracle.simulate(n=30, p=50, c=1, seed=5)[3]
    n_t = tcmp.write_sparse_grm(str(tmp_path / "t"), K, cutoff=0.05)
    n_j = jcmp.write_sparse_grm(str(tmp_path / "j"), K, cutoff=0.05)
    assert n_t == n_j
    for ext in (".grm.sp", ".grm.id"):
        assert (tmp_path / f"t{ext}").read_text() \
            == (tmp_path / f"j{ext}").read_text()


def test_bridges_skip_without_binaries(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    for var in ("GEMMA", "GCTA", "RSCRIPT", "REGENIE"):
        monkeypatch.delenv(var, raising=False)
    args = (np.zeros(4), np.zeros((4, 2)), None, np.eye(4))
    assert tcmp.find_gemma() is None and tcmp.run_gemma(*args) is None
    assert tcmp.find_gcta() is None and tcmp.run_gcta(*args) is None
    assert tcmp.run_fastgwa(*args) is None
    assert tcmp.find_rscript() is None and tcmp.run_emma(*args) is None
    assert tcmp.find_regenie() is None
    assert tcmp.run_regenie(*args[:3]) is None


def test_emma_reml_t_matches_jax_and_the_engine():
    """The NumPy EMMA is the JAX package's to the last bit, and agrees with
    the port's float64 scan (tests/test_extras.py's tolerances)."""
    import pygemma_tpu_torch as pt

    y, G, W, K = oracle.simulate(n=80, p=6, c=2, seed=3)
    got = tcmp.emma_reml_t(y, G, W, K)
    pd.testing.assert_frame_equal(got, jcmp.emma_reml_t(y, G, W, K))
    df = pt.pygemma(y, G, W, K, device="cpu",
                    config=pt.GwasConfig(dtype="float64", snp_block=8))
    np.testing.assert_allclose(df["beta"], got["beta"], rtol=1e-3)
    np.testing.assert_allclose(df["lambda"], 1.0 / got["delta"], rtol=3e-3)
    np.testing.assert_allclose(-np.log10(df["p_wald"]),
                               -np.log10(got["p_wald"]), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("a,b", [
    ([0.5, 1e-4, 0.01], [0.5, 1.2e-4, 0.011]),
    ([0.5, np.nan, 0.0, 1e-320], [0.4, 0.3, 1e-5, 1e-10]),
    ([0.2], [0.3]),
])
def test_compare_pvalues_matches_jax(a, b):
    da, db = pd.DataFrame({"p_wald": a}), pd.DataFrame({"p_wald": b})
    got, ref = tcmp.compare_pvalues(da, db), jcmp.compare_pvalues(da, db)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
