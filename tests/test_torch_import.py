"""The PyTorch port stands alone: no JAX, no JAX package, CUDA by default,
full-precision matmuls, and loud refusals for what it does not cover."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pygemma_tpu_torch as pt
from pygemma_tpu import config as jcfg
from pygemma_tpu_torch import config as tcfg
from pygemma_tpu_torch.convert import config_from_fields

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT_MODULES = [
    "pygemma_tpu_torch", "pygemma_tpu_torch.api", "pygemma_tpu_torch.config",
    "pygemma_tpu_torch.convert", "pygemma_tpu_torch.sim",
    "pygemma_tpu_torch.device",
    "pygemma_tpu_torch.core.assoc", "pygemma_tpu_torch.core.eigen",
    "pygemma_tpu_torch.core.eigh_dc",
    "pygemma_tpu_torch.core.grams", "pygemma_tpu_torch.core.lowrank",
    "pygemma_tpu_torch.core.reml", "pygemma_tpu_torch.core.solver",
    "pygemma_tpu_torch.io.packed", "pygemma_tpu_torch.io.plink",
    "pygemma_tpu_torch.io.quantized", "pygemma_tpu_torch.io.rawbin",
    "pygemma_tpu_torch.io.streaming", "pygemma_tpu_torch.ops.gram_kernel",
    "pygemma_tpu_torch.ops.rotate_kernel",
    "pygemma_tpu_torch.utils.checkpoint", "pygemma_tpu_torch.utils.logging",
    "pygemma_tpu_torch.__main__", "pygemma_tpu_torch.io",
    "pygemma_tpu_torch.io.bimbam", "pygemma_tpu_torch.io.traw",
    "pygemma_tpu_torch.io.gemma_format", "pygemma_tpu_torch.io.kinship",
    "pygemma_tpu_torch.native.bed_native", "pygemma_tpu_torch.linreg",
    "pygemma_tpu_torch.preprocess", "pygemma_tpu_torch.plotting",
    "pygemma_tpu_torch.plotting.plot", "pygemma_tpu_torch.compare",
    "pygemma_tpu_torch.utils.profiling", "pygemma_tpu_torch.parallel",
    "pygemma_tpu_torch.parallel.mesh", "pygemma_tpu_torch.parallel.dist",
    "pygemma_tpu_torch.parallel.distributed",
    "pygemma_tpu_torch.parallel.slabs",
]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pygemma_tpu")


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in PORT_MODULES)
        + "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pygemma_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in list((ROOT / "pygemma_tpu_torch").rglob("*.py"))
    + list((ROOT / "experiments").glob("*/*_torch.py"))
    + [ROOT / "chip_smoke.py", ROOT / "k1_ablation.py",
       ROOT / "configs" / "run_config_torch.py",
       ROOT / "tests" / "test_torch_cuda.py"]))
def test_source_imports_no_jax(path):
    bad = [m for m in _imports(ROOT / path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_config_matches_jax_field_by_field():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.GwasConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.GwasConfig)}
    assert jf == tf
    assert tcfg.MIN_VAL == jcfg.MIN_VAL
    assert (tcfg.LAMBDA_POW_LOW, tcfg.LAMBDA_POW_HIGH) == (
        jcfg.LAMBDA_POW_LOW, jcfg.LAMBDA_POW_HIGH)
    assert tcfg.GwasConfig().n_grid == jcfg.GwasConfig().n_grid
    j = jcfg.GwasConfig(dtype="float64", tests=("wald", "lrt"), grid=True,
                        snp_block=64, use_fused_kernel=False)
    assert dataclasses.asdict(config_from_fields(dataclasses.asdict(j))) \
        == dataclasses.asdict(j)


def test_from_env_reads_the_same_names(monkeypatch):
    monkeypatch.setenv("PYGEMMA_TPU_SNP_BLOCK", "96")
    monkeypatch.setenv("PYGEMMA_TPU_TESTS", "wald,score")
    monkeypatch.setenv("PYGEMMA_TPU_USE_FUSED_KERNEL", "auto")
    monkeypatch.setenv("PYGEMMA_TPU_NEWTON_RTOL", "1e-6")
    assert dataclasses.asdict(tcfg.from_env()) == dataclasses.asdict(
        jcfg.from_env())
    assert tcfg.from_env().snp_block == 96


def test_matmul_precision_is_full_fp32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def _tiny():
    rng = np.random.default_rng(0)
    n = 12
    X = rng.normal(size=(n, 3))
    return rng.normal(size=n), X, np.ones((n, 1)), np.eye(n)


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from pygemma_tpu_torch import __main__ as cli
    from pygemma_tpu_torch.core.eigen import auto_eigendecompose
    from pygemma_tpu_torch.io import bimbam, kinship, plink
    from pygemma_tpu_torch.io.streaming import SnpBlockStreamer
    from pygemma_tpu_torch.parallel import distributed, mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y, X, W, K = _tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.pygemma(y, X, W, K)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.estimate_lambda(np.ones(12), y, W)
    for fn in (kinship.kinship_blocked, kinship.centered_kinship,
               kinship.standardized_kinship):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(X)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.linreg.linreg(y, X, W)
    with pytest.raises(RuntimeError, match="CUDA"):
        SnpBlockStreamer(X, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        auto_eigendecompose(K)
    # a rank without a card raises; it does not move to the CPU
    for fn in (mesh.make_mesh, distributed.initialize):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    plink.write_bed(str(tmp_path / "g"), np.rint(np.abs(X)).clip(0, 2))
    bimbam.write_pheno(str(tmp_path / "y.txt"), y)
    args = ["run", "--bfile", str(tmp_path / "g"), "--pheno",
            str(tmp_path / "y.txt"), "--out", str(tmp_path / "o.tsv")]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args)
    df = pt.pygemma(y, X, W, K, device="cpu")
    assert df.shape == (3, 6)
    assert kinship.kinship_blocked(X, device="cpu").shape == (12, 12)
    assert len(list(SnpBlockStreamer(X, 2, device="cpu"))) == 2
    assert auto_eigendecompose(K, device="cpu")[1].shape == (12, 12)
    cli.main(args + ["--device", "cpu", "--verbose", "0"])
    assert (tmp_path / "o.tsv").exists()


def test_entry_points_refuse_tf32(monkeypatch):
    y, X, W, K = _tiny()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32 is True"):
        pt.pygemma(y, X, W, K, device="cpu")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="precision.. is 'high'"):
            pt.estimate_lambda(np.ones(12), y, W, device="cpu")
    finally:
        torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("case", ["lowrank", "quantized", "packed", "mesh"])
def test_unported_inputs_raise(case):
    """The JAX package's own matrix and kinship classes are refused with a
    TypeError that names the converter, and its mesh (or any object that is
    not the port's mesh) with one that names the port's ``make_mesh``."""
    from pygemma_tpu.core.lowrank import LowRankKinship
    from pygemma_tpu.io.packed import PackedMatrix
    from pygemma_tpu.io.quantized import QuantizedMatrix

    y, X, W, K = _tiny()
    kw = {}
    err, match = TypeError, "pygemma_tpu_torch.convert.from_jax"
    codes = np.random.default_rng(0).integers(0, 3, size=X.shape)
    if case == "lowrank":
        K = LowRankKinship(X[:, :2], eps=1e-3)
    elif case == "quantized":
        X = QuantizedMatrix.from_dosages(codes.astype(np.int8))
    elif case == "packed":
        X = PackedMatrix.from_codes(codes.astype(np.uint8))
    else:
        from pygemma_tpu.parallel.mesh import make_mesh

        err, match = TypeError, "parallel.mesh.make_mesh"
        kw["mesh"] = make_mesh(snp=2)
    with pytest.raises(err, match=match):
        pt.pygemma(y, X, W, K, device="cpu", **kw)
