"""The workload layer on PyTorch (experiments/*/*_torch.py and
configs/run_config_torch.py) against the JAX package's scripts.

tests/test_experiments.py's ten cases run the torch scripts in process with
``--device cpu``.  Each original script runs on the same arguments in one
child process (and the scenario functions' driver calls are captured
there), and every table a script writes is held to the original's:
|d log10 p| < 0.05 (the float32 contract), beta within 5e-3 of |beta| +
se for the LMM (a flat REML optimum moves beta between two float32 runs)
and 1e-4 relative for least squares, NaN rows and every other column equal.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "experiments")
CFG = os.path.join(ROOT, "configs")
DLOGP, LMM_BETA, OLS_BETA_RTOL = 0.05, 5e-3, 1e-4

#: case -> (script without extension, arguments; {io} is the inputs' dir)
CASES = {
    "animal": ("animal_gwas/run_gwas",
               ["--n", "80", "--p", "60", "--pcs", "1"]),
    "eqtl": ("eqtl/run_genes", ["--n", "60", "--p", "40", "--genes", "2"]),
    "case_control": ("case_control/run",
                     ["--n-cases", "30", "--n-controls", "40", "--p", "50",
                      "--linear"]),
    "large_gwas": ("large_gwas/run_pygemma",
                   ["--geno", "{io}/geno", "--pheno", "{io}/pheno",
                    "--covar", "{io}/covar", "--eigenvalues", "{io}/eig.txt"]),
    "ukb_afr": ("ukb_afr/run_chrom",
                ["--n", "70", "--p-per-chrom", "30", "--chroms", "20,21",
                 "--pcs", "2", "--null-diagnostics"]),
    "cc_bimbam": ("case_control/run",
                  ["--n-cases", "20", "--n-controls", "30", "--p", "40",
                   "--write-bimbam"]),
    "eqtl_gd449": ("eqtl/run_genes",
                   ["--p", "30", "--pheno-tsv", "{io}/pheno.tsv",
                    "--gemma-compare", "--summary"]),
    "eqtl_traw": ("eqtl/run_genes",
                  ["--genes", "2", "--traw", "{io}/g.traw", "--summary"]),
}
#: the torch script of each original
TORCH = {"animal_gwas/run_gwas": "animal_gwas/run_gwas_torch",
         "eqtl/run_genes": "eqtl/run_genes_torch",
         "case_control/run": "case_control/run_torch",
         "large_gwas/run_pygemma": "large_gwas/run_pygemma_torch",
         "ukb_afr/run_chrom": "ukb_afr/run_chrom_torch"}
#: scenario -> scale, as in tests/test_experiments.py
SCENARIOS = {"mouse_hs1940": 0.03, "bxd": 0.05}

_GEMMA_STUB = (
    "#!/bin/bash\n"
    "while [[ $# -gt 0 ]]; do\n"
    "  case $1 in\n"
    "    -outdir) OUT=$2; shift 2;;\n"
    "    -o) NAME=$2; shift 2;;\n"
    "    -g) GENO=$2; shift 2;;\n"
    "    *) shift;;\n"
    "  esac\n"
    "done\n"
    "NSNP=$(wc -l < $GENO)\n"
    "printf 'chr\\trs\\tps\\tn_miss\\tallele1\\tallele0\\taf\\tbeta\\t"
    "se\\tlogl_H1\\tl_remle\\tp_wald\\n' > $OUT/$NAME.assoc.txt\n"
    "for i in $(seq 1 $NSNP); do\n"
    "  printf -- \"1\\trs$i\\t$i\\t0\\tA\\tT\\t0.3\\t0.1\\t0.2\\t-10\\t"
    "1.0\\t0.5\\n\" >> $OUT/$NAME.assoc.txt\n"
    "done\n"
)

_CHILD = r"""
import importlib.util
import os
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
root, io_dir, out_dir = sys.argv[1:4]
sys.path.insert(0, root)
import pygemma_tpu

CASES = %(cases)r
SCENARIOS = %(scenarios)r


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


os.environ.update(TASK_ID="0", TASK_COUNT="1",
                  GEMMA=os.path.join(io_dir, "gemma"))
for case, (script, args) in CASES.items():
    mod = load(os.path.join(root, "experiments", script + ".py"), "j_" + case)
    sys.argv = [script] + [a.replace("{io}", io_dir) for a in args] + [
        "--out" if case == "large_gwas" else "--out-dir",
        os.path.join(out_dir, case + (".txt" if case == "large_gwas"
                                      else ""))]
    mod.main()

cfg = load(os.path.join(root, "configs", "run_config.py"), "j_cfg")
tables = []
real = pygemma_tpu.pygemma
pygemma_tpu.pygemma = lambda *a, **k: tables.append(real(*a, **k)) or \
    tables[-1]
for name, scale in SCENARIOS.items():
    getattr(cfg, name)(scale)
    tables.pop().to_csv(os.path.join(out_dir, name + ".csv"), index=False)
"""


def _write_inputs(io):
    """The inputs of tests/test_experiments.py's cases: pre-rotated rawbins
    and eigenvalues for large_gwas, a GD449-style phenotype TSV and a GEMMA
    stub for eqtl, a .traw file."""
    import oracle
    from pygemma_tpu_torch.io import rawbin

    y, G, W, K = oracle.simulate(n=50, p=20, c=2, seed=6)
    ev, U = np.linalg.eigh(K)
    rawbin.write_rawbin(f"{io}/geno", (U.T @ G).astype(np.float32))
    rawbin.write_rawbin(f"{io}/pheno", (U.T @ y).astype(np.float32)[:, None])
    rawbin.write_rawbin(f"{io}/covar", (U.T @ W).astype(np.float32))
    np.savetxt(f"{io}/eig.txt", np.maximum(ev, 0))

    rng = np.random.default_rng(0)
    pd.DataFrame({"IID": [f"s{i}" for i in range(60)],
                  **{f"Pheno{j}": rng.normal(size=60) for j in (1, 2, 3)}}
                 ).to_csv(f"{io}/pheno.tsv", sep="\t", index=False)
    with open(f"{io}/gemma", "w") as f:
        f.write(_GEMMA_STUB)
    os.chmod(f"{io}/gemma", 0o755)

    n, p = 40, 12
    Xi = np.random.default_rng(3).integers(0, 3, size=(n, p))
    with open(f"{io}/g.traw", "w") as f:
        f.write("CHR\tSNP\t(C)M\tPOS\tCOUNTED\tALT\t"
                + "\t".join(f"F{i}_I{i}" for i in range(n)) + "\n")
        for j in range(p):
            vals = "\t".join(str(v) for v in Xi[:, j])
            f.write(f"1\trs{j}\t0\t{j+1}\tA\tT\t{vals}\n")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(inputs, the originals' outputs): the originals run in one child."""
    io = str(tmp_path_factory.mktemp("io"))
    ref = str(tmp_path_factory.mktemp("jax_out"))
    _write_inputs(io)
    code = _CHILD % {"cases": CASES, "scenarios": SCENARIOS}
    r = subprocess.run([sys.executable, "-c", code, ROOT, io, ref],
                       capture_output=True, text=True, timeout=600, cwd=ref)
    assert r.returncode == 0, r.stderr[-3000:]
    return io, ref


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_torch(case, dirs, tmp_path, monkeypatch):
    """The torch script of ``case`` with the case's arguments and
    ``--device cpu``; returns (its output path, the original's)."""
    io, ref = dirs
    script, args = CASES[case]
    monkeypatch.setenv("TASK_ID", "0")
    monkeypatch.setenv("TASK_COUNT", "1")
    monkeypatch.setenv("GEMMA", os.path.join(io, "gemma"))
    large = script.startswith("large_gwas")
    out = str(tmp_path / (case + (".txt" if large else "")))
    mod = _load(os.path.join(EXP, TORCH[script] + ".py"), "t_" + case)
    argv = [a.replace("{io}", io) for a in args]
    argv += ["--out" if large else "--out-dir", out, "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", [script] + argv)
    mod.main()
    return out, os.path.join(ref, os.path.basename(out))


def _held(path, ref_path, sep="\t", ols=False):
    """A table the torch script wrote against the original's."""
    got, ref = pd.read_csv(path, sep=sep), pd.read_csv(ref_path, sep=sep)
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref)
    for col in ref.columns:
        a, b = got[col].to_numpy(), ref[col].to_numpy()
        if a.dtype.kind not in "fc" or b.dtype.kind not in "fc":
            np.testing.assert_array_equal(a, b, err_msg=col)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=col)
        ok = ~np.isnan(b)
        if col.startswith("p_"):
            d = np.abs(np.log10(np.maximum(a[ok], 1e-300))
                       - np.log10(np.maximum(b[ok], 1e-300)))
            assert d.max() < DLOGP, (col, d.max())
        elif col == "beta" and ols:
            np.testing.assert_allclose(a[ok], b[ok], rtol=OLS_BETA_RTOL,
                                       atol=1e-7, err_msg=col)
        elif col == "beta":
            se_col = "se_beta" if "se_beta" in ref else "se"  # GEMMA's name
            se = ref[se_col].to_numpy()[ok]
            rel = np.abs(a[ok] - b[ok]) / (np.abs(b[ok]) + se)
            assert rel.max() <= LMM_BETA, rel.max()
    return got


def test_animal_gwas_pipeline(dirs, tmp_path, monkeypatch):
    out, ref = _run_torch("animal", dirs, tmp_path, monkeypatch)
    _held(os.path.join(out, "assoc.tsv"), os.path.join(ref, "assoc.tsv"))
    assert os.path.exists(os.path.join(out, "manhattan.png"))


def test_eqtl_pipeline(dirs, tmp_path, monkeypatch):
    out, ref = _run_torch("eqtl", dirs, tmp_path, monkeypatch)
    for gene in ("gene0", "gene1"):
        _held(os.path.join(out, gene, "lmm.tsv"),
              os.path.join(ref, gene, "lmm.tsv"))
        _held(os.path.join(out, gene, "linreg.tsv"),
              os.path.join(ref, gene, "linreg.tsv"), ols=True)


def test_case_control_pipeline(dirs, tmp_path, monkeypatch):
    out, ref = _run_torch("case_control", dirs, tmp_path, monkeypatch)
    _held(os.path.join(out, "lmm.tsv"), os.path.join(ref, "lmm.tsv"))
    _held(os.path.join(out, "linreg.tsv"), os.path.join(ref, "linreg.tsv"),
          ols=True)


def test_large_gwas_pipeline(dirs, tmp_path, monkeypatch):
    out, ref = _run_torch("large_gwas", dirs, tmp_path, monkeypatch)
    df = _held(out, ref)
    assert len(df) == 20 and np.isfinite(df["p_wald"]).all()


def test_large_gwas_mesh_names_torchrun(dirs, tmp_path, monkeypatch):
    """--mesh 2 outside a launcher's group of two ranks raises, naming
    torchrun."""
    monkeypatch.setitem(CASES, "large_gwas_mesh", (
        CASES["large_gwas"][0], CASES["large_gwas"][1] + ["--mesh", "2"]))
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        _run_torch("large_gwas_mesh", dirs, tmp_path, monkeypatch)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def test_large_gwas_mesh_under_torchrun(dirs, tmp_path):
    """``torchrun --nproc-per-node 2 ... --mesh 2``: two gloo ranks on the
    CPU join the launcher's group; rank 0 writes the original's table."""
    io, ref = dirs
    script, args = CASES["large_gwas"]
    out = str(tmp_path / "large_gwas.txt")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", os.path.join(EXP, TORCH[script] + ".py"),
           *[a.replace("{io}", io) for a in args], "--mesh", "2",
           "--device", "cpu", "--out", out]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    _held(out, os.path.join(ref, "large_gwas.txt"))


def test_ukb_afr_pipeline(dirs, tmp_path, monkeypatch):
    """Per-chromosome pipeline with imputation, PCs, a shared eigh
    checkpoint, QQ/Manhattan plots and null-model diagnostics."""
    out, ref = _run_torch("ukb_afr", dirs, tmp_path, monkeypatch)
    for name in ("pygemma_results_chr20_pheno0.csv",
                 "pygemma_results_chr21_pheno0.csv", "all_chrom_results.csv"):
        df = _held(os.path.join(out, name), os.path.join(ref, name), sep=",")
        assert np.isfinite(df["p_wald"]).mean() > 0.8
    for name in ("chr20_pheno0_wald_qq.png", "residuals.png",
                 "residuals_vs_fitted.png", "manhattan.png",
                 os.path.join("checkpoint", "eigen.npz")):
        assert os.path.exists(os.path.join(out, name)), name


def test_case_control_bimbam_crosscheck_writer(dirs, tmp_path, monkeypatch):
    """--write-bimbam writes the same GEMMA cross-check inputs as the
    original: genotypes and phenotypes byte for byte, the kinship to
    float32 rounding."""
    from pygemma_tpu_torch.io import bimbam

    out, ref = _run_torch("cc_bimbam", dirs, tmp_path, monkeypatch)
    for name in ("cc_genotypes.tsv", "cc_phenotypes.tsv"):
        with open(os.path.join(out, name), "rb") as f, \
                open(os.path.join(ref, name), "rb") as g:
            assert f.read() == g.read(), name
    K = bimbam.read_matrix(os.path.join(out, "cc_kinship.txt"))
    K_ref = bimbam.read_matrix(os.path.join(ref, "cc_kinship.txt"))
    assert K.shape == (50, 50)
    np.testing.assert_allclose(K, K_ref, rtol=1e-5,
                               atol=1e-6 * np.abs(K_ref).max())
    _held(os.path.join(out, "lmm.tsv"), os.path.join(ref, "lmm.tsv"))


def test_eqtl_pipeline_gd449_pheno_and_summary(dirs, tmp_path, monkeypatch):
    """A GD449-style phenotype table as the expression matrix, the GEMMA
    cross-check through a stub binary, and the summary stage."""
    out, ref = _run_torch("eqtl_gd449", dirs, tmp_path, monkeypatch)
    for gene in ("Pheno1", "Pheno2", "Pheno3"):
        _held(os.path.join(out, gene, "lmm.tsv"),
              os.path.join(ref, gene, "lmm.tsv"))
        _held(os.path.join(out, gene, "gemma.tsv"),
              os.path.join(ref, gene, "gemma.tsv"))
        assert os.path.exists(os.path.join(out, gene, "gemma_agreement.json"))
    summ = pd.read_csv(os.path.join(out, "summary.csv"))
    ref_summ = pd.read_csv(os.path.join(ref, "summary.csv"))
    assert list(summ.columns) == list(ref_summ.columns)
    assert list(summ["gene"]) == list(ref_summ["gene"])
    np.testing.assert_allclose(summ["lambda_gc_lmm"],
                               ref_summ["lambda_gc_lmm"], rtol=0.05)


def test_eqtl_pipeline_traw_ingest(dirs, tmp_path, monkeypatch):
    """--traw genotype ingest."""
    out, ref = _run_torch("eqtl_traw", dirs, tmp_path, monkeypatch)
    _held(os.path.join(out, "gene0", "lmm.tsv"),
          os.path.join(ref, "gene0", "lmm.tsv"))
    assert os.path.exists(os.path.join(out, "summary.csv"))


def test_config_scenarios_smoke(dirs, tmp_path, capsys):
    """mouse_hs1940 and bxd: the table each scenario scans, against the one
    the original scenario's driver call returned."""
    mod = _load(os.path.join(CFG, "run_config_torch.py"), "t_cfg")
    for name, scale in SCENARIOS.items():
        path = str(tmp_path / (name + ".csv"))
        getattr(mod, name)(scale, device="cpu").to_csv(path, index=False)
        _held(path, os.path.join(dirs[1], name + ".csv"), sep=",")
    out = capsys.readouterr().out
    assert "[mouse_hs1940]" in out and "[bxd]" in out


def test_ukb_synth_scenario_streams_packed(tmp_path, capsys):
    """ukb_synth writes its 2-bit cohort under --cache-dir and scans it
    through the implicit low-rank kinship, streamed."""
    mod = _load(os.path.join(CFG, "run_config_torch.py"), "t_cfg2")
    df = mod.ukb_synth(0.004, device="cpu", cache_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert "ukb_synth" in out and "lambda_GC" in out
    assert os.path.exists(os.path.join(tmp_path, "geno_n200_p400.2b"))
    assert len(df) == 400 and np.isfinite(df["p_wald"]).mean() > 0.99


def test_large_gwas_sharded_scenario_on_one_rank(capsys):
    """large_gwas_sharded without a launcher: a one-rank world (gloo on the
    CPU) that it starts and closes."""
    import torch.distributed as dist

    mod = _load(os.path.join(CFG, "run_config_torch.py"), "t_cfg3")
    df = mod.large_gwas_sharded(0.02, device="cpu")
    assert "[large_gwas_sharded]" in capsys.readouterr().out
    assert len(df) == int(8000 * 0.02) + 256
    assert not dist.is_initialized()
