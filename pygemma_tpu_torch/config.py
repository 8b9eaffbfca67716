"""Run-time configuration for the PyTorch/CUDA LMM-GWAS engine.

The reference (rlangefe/pygemma) has no config system: behaviour is spread over
``pygemma()`` kwargs (``lmm/lmm.py:87``), argparse CLIs and environment
variables (``experiments/wtccc/run_pygemma.py:14-19``).  Here every tunable is
a field on :class:`GwasConfig`, overridable from the environment with a
``PYGEMMA_TPU_`` prefix -- the same fields, defaults and variable names as
``pygemma_tpu.config``, so one environment configures both packages.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

# Pivot/denominator clamp used throughout the reference numeric kernels
# (reference pygemma_model/pygemma_model.pyx:39).
MIN_VAL = 1e-35

# Decade bracketing range for the variance-ratio lambda
# (reference pygemma_model/pygemma_model.pyx:85-86).
LAMBDA_POW_LOW = -5.0
LAMBDA_POW_HIGH = 5.0


@dataclasses.dataclass(frozen=True)
class GwasConfig:
    """All knobs for one GWAS run.

    Defaults reproduce the reference driver semantics
    (``lmm/lmm.py:87`` kwargs ``grid``, ``eigen``, ``de`` ...).
    """

    # --- numerics -----------------------------------------------------------
    #: device compute dtype ("float32" on the GPU; "float64" for CPU oracle
    #: runs)
    dtype: str = "float32"
    #: clamp for denominators / quadratic forms (pygemma_model.pyx:39)
    min_val: float = MIN_VAL
    #: "auto" | "device" | "host" | "dc" -- where the kinship eigh runs.
    #: "auto" falls back to host LAPACK when the device eigh's workspace
    #: cannot fit the card's free memory; "dc" is the spectral divide and
    #: conquer (core/eigen.py::auto_eigendecompose, core/eigh_dc.py).
    eigh_backend: str = "auto"
    #: implicit-complement scan for LowRankKinship inputs.  Kept so that a
    #: JAX-package config carries over field by field; low-rank kinships
    #: are not handled by this package yet.
    lowrank_implicit: Optional[bool] = None

    # --- lambda optimizer ---------------------------------------------------
    #: decade-bracket endpoints: lambda in [10**low, 10**high]
    lambda_pow_low: float = LAMBDA_POW_LOW
    lambda_pow_high: float = LAMBDA_POW_HIGH
    #: number of masked GEOMETRIC bisection iterations per bracketed root.
    #: k iterations shrink a decade bracket to the RATIO 10^(1/2^k): 4 gives
    #: ~15% relative width uniformly over the decade -- the same handoff
    #: regime as the reference's brentq rtol=0.1 (pyx:179), after which
    #: safeguarded Newton converges quadratically.  Each extra iteration
    #: costs one full per-SNP-lambda d1 evaluation.
    bisect_iters: int = 4
    #: number of masked safeguarded-Newton iterations per root
    newton_iters: int = 10
    #: Newton relative-step convergence tolerance (pygemma_model.pyx:1411)
    newton_rtol: float = 1e-5
    #: maximum number of sign-change brackets refined per SNP.  0 (default)
    #: refines EVERY sign-change bracket, matching the reference's exhaustive
    #: sequential scan (pygemma_model.pyx:154-194); the solver compacts live
    #: root problems into batches so unused brackets cost nothing.  A
    #: positive value caps the brackets per SNP (benchmark knob only).
    max_roots: int = 0
    #: use the pure grid search instead of bracket+Newton
    #: (reference grid=True path, pygemma_model.pyx:99-132)
    grid: bool = False
    #: hand-written CUDA Gram kernel for per-SNP-lambda evaluations
    #: (ops/gram_kernel.py).  None = auto (on for float32 CUDA tensors, off
    #: on the CPU, where the kernel's plain PyTorch version would run).
    use_fused_kernel: Optional[bool] = None

    # --- batching / sharding ------------------------------------------------
    #: SNPs per device batch; the driver pads the final block.  Analogous to the reference's SNP-block split
    #: (lmm/lmm.py:427-436) but vectorized instead of multiprocessed.
    snp_block: int = 2048
    #: mesh axis names, kept for field parity (multi-device runs are not
    #: handled by this package yet)
    snp_axis: str = "snp"
    sample_axis: str = "sample"

    # --- statistical tests --------------------------------------------------
    #: which association tests to run.  The reference implements Wald only
    #: (lmm/lmm.py:461-495); "lrt" and "score" follow GEMMA's -lmm 2/3.
    tests: Tuple[str, ...] = ("wald",)

    # --- behaviour flags (reference kwarg parity) ---------------------------
    verbose: int = 0
    disable_checks: bool = True

    def replace(self, **kw) -> "GwasConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_grid(self) -> int:
        """Number of decade points: 10^low .. 10^high inclusive."""
        return int(round(self.lambda_pow_high - self.lambda_pow_low)) + 1


def _coerce(val: str, default):
    """Coerce an env string by the field's DEFAULT value type (annotations
    are strings under ``from __future__ import annotations``, so they can't
    drive the dispatch).  Fields defaulting to None (tri-state booleans)
    accept none/auto as None and booleans otherwise."""
    if default is None:
        low = val.lower()
        if low in ("", "none", "auto"):
            return None
        return low in ("1", "true", "yes", "on")
    if isinstance(default, bool):
        return val.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(val)
    if isinstance(default, float):
        return float(val)
    if isinstance(default, tuple):
        return tuple(s.strip() for s in val.split(",") if s.strip())
    return val


def from_env(base: Optional[GwasConfig] = None) -> GwasConfig:
    """Build a config overriding fields from ``PYGEMMA_TPU_<FIELD>`` env vars."""
    cfg = base or GwasConfig()
    updates = {}
    for f in dataclasses.fields(GwasConfig):
        key = "PYGEMMA_TPU_" + f.name.upper()
        if key in os.environ:
            updates[f.name] = _coerce(os.environ[key], getattr(cfg, f.name))
    return cfg.replace(**updates) if updates else cfg
