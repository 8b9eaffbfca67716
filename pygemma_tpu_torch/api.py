"""Public driver: ``pygemma(Y, X, W, K, ...) -> pandas.DataFrame``.

API-compatible with the reference driver (``lmm.pygemma``, reference
lmm/lmm.py:87) and with ``pygemma_tpu.pygemma``: the same arguments, the same
table.  The scan runs eagerly on a torch device, SNP block by SNP block.

Output schema: ``beta, se_beta, tau, lambda, F_wald, p_wald`` (+ ``SNPs``
when snp names are given; reference lmm/lmm.py:403-411), extended with
``p_lrt`` / ``p_score`` / ``logl_H1`` when those tests are requested.

Genotypes come as a float array or streamed as 2-bit or int8 codes
(:class:`~pygemma_tpu_torch.io.packed.PackedMatrix`,
:class:`~pygemma_tpu_torch.io.quantized.QuantizedMatrix`) that dequantize
on the device.  The kinship is dense (or precomputed eigenvalues with
``eigen=False``) or a :class:`~pygemma_tpu_torch.core.lowrank.LowRankKinship`,
scanned by default in its top eigenspace with the complement folded in
implicitly.  With three or more phenotypes (and no ``run_dir``, no mesh)
each SNP block streams once and is rotated, or prepared in the top space,
once for all of them; otherwise phenotypes are scanned one column at a time.
With ``mesh=`` (:func:`pygemma_tpu_torch.parallel.mesh.make_mesh`) the scan
is SNP-sharded over the ranks of a ``torch.distributed`` group, one process
each, and every rank returns the same table.  ``eigh_backend="dc"`` runs
the spectral divide-and-conquer eigh (core/eigh_dc.py); under a mesh rank 0
computes the basis and broadcasts it, as for every backend.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import hashlib
import os
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import pandas as pd
import torch
from scipy import stats
from torch.distributed.device_mesh import DeviceMesh

from .config import GwasConfig, from_env
from .convert import is_jax_object
from .core.assoc import (
    ImplicitCtx,
    ImplicitMultiCtx,
    NullFit,
    assoc_block,
    assoc_block_multi,
    fit_null,
    fit_null_multi,
)
from .core.eigen import auto_eigendecompose, loading_transform, rotate
from .core.grams import pair_products, pdot
from .core.lowrank import (
    LowRankKinship,
    lowrank_eigendecompose,
    lowrank_top_basis,
)
from .core.solver import LambdaProblem, solve_lambda
from .device import resolve_device, torch_dtype
from .io.packed import PackedMatrix
from .io.quantized import QuantizedMatrix
from .io.streaming import (
    SnpBlockStreamer,
    _cache_budget_bytes,
    prefill_device_cache,
)
from .ops import rotate_kernel
from .parallel import distributed
from .parallel.dist import from_rank0, gather_columns, sharded_eigh_fn
from .parallel.mesh import axis_shard, is_writer, put_replicated, rank_device
from .utils.checkpoint import RunCheckpoint
from .utils import profiling
from .utils.logging import StageLogger

#: genotype matrices that stream as codes and dequantize on the device
_STREAMED = (PackedMatrix, QuantizedMatrix)

#: single-entry device-resident eigendecomposition cache, keyed by the
#: kinship fingerprint and device: repeated ``pygemma`` calls against the
#: same kinship (multi-phenotype studies, warm-then-measure benchmarks)
#: reuse the on-device (ev, U).  One entry, so stale bases never pile up.
_EIGEN_DEV_CACHE: dict = {}


def _reject_unported(K, X, mesh) -> None:
    for name, obj in (("X", X), ("K", K)):
        if is_jax_object(obj):
            raise TypeError(
                f"{name} is a {type(obj).__module__}.{type(obj).__name__}, "
                "an object of the JAX package; convert it with "
                "pygemma_tpu_torch.convert.from_jax first")
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh is a {type(mesh).__module__}.{type(mesh).__name__}; build "
            "it with pygemma_tpu_torch.parallel.mesh.make_mesh")


def _result_keys(cfg) -> list:
    """Device-result rows of a stacked association block, in static order."""
    keys = ["beta", "se_beta", "tau", "lam", "F_wald"]
    if "lrt" in cfg.tests:
        keys += ["lambda_ml", "logl_H1"]
    if "score" in cfg.tests:
        keys += ["F_score"]
    return keys


def _assoc_block(ev, W, y, Xblock, cfg, null_arr, de,
                 implicit: Optional[ImplicitCtx] = None) -> torch.Tensor:
    """One SNP block -> a single stacked (n_keys, B) tensor, so the driver
    pulls one buffer per block.  Traced as a ``reml`` span."""
    null = (NullFit(null_arr[0], null_arr[1], null_arr[2])
            if null_arr is not None else None)
    with profiling.span("reml"):
        res = assoc_block(ev, W, y, Xblock, cfg, null=null, de=de,
                          pvalues=False, implicit=implicit)
        d = res._asdict()
        return torch.stack([d[k] for k in _result_keys(cfg)])


def _fit_null(ev, W, y, cfg,
              implicit: Optional[ImplicitCtx] = None) -> torch.Tensor:
    nf = fit_null(ev, W, y, cfg, implicit=implicit)
    return torch.stack([nf.lambda_reml, nf.lambda_ml, nf.loglik_ml])


def _assoc_multi(ev, W, Y_kn, Xblock, cfg, null_stack, de,
                 implicit_multi: Optional[ImplicitMultiCtx] = None
                 ) -> torch.Tensor:
    """One SNP block against k phenotypes -> one stacked (n_keys, k, B)
    tensor (see :func:`_assoc_block`), traced as one ``reml`` span."""
    with profiling.span("reml"):
        res = assoc_block_multi(ev, W, Y_kn, Xblock, cfg,
                                null_stack=null_stack, de=de,
                                implicit_multi=implicit_multi, pvalues=False)
        return torch.stack([res[k] for k in _result_keys(cfg)])


def _table_columns(d: dict, null_ml, tests) -> dict:
    """Result rows by :func:`_result_keys` name -> the table's columns, with
    the LRT statistic D = 2 (logl_H1 - logl_null) in float64 on the host."""
    out = {"beta": d["beta"], "se_beta": d["se_beta"], "tau": d["tau"],
           "lambda": d["lam"], "F_wald": d["F_wald"]}
    if "lrt" in tests:
        out["lambda_ml"] = d["lambda_ml"]
        out["logl_H1"] = d["logl_H1"]
        out["D_lrt"] = 2.0 * (d["logl_H1"].astype(np.float64) - null_ml)
    if "score" in tests:
        out["F_score"] = d["F_score"]
    return out


def _frame(out: dict, n: int, c: int, tests, pheno=None) -> pd.DataFrame:
    """One phenotype's columns -> its table: host p-values, the reference's
    column order (lmm/lmm.py:129-142), a ``pheno`` column when given."""
    _host_pvalues(out, n, c, tests)
    df = pd.DataFrame(out)
    order = ["beta", "se_beta", "tau", "lambda", "F_wald", "p_wald"]
    order += [k for k in df.columns if k not in order]
    df = df[order]
    if pheno is not None:
        df["pheno"] = pheno
    return df


# --- implicit low-rank scan helpers (no n x n eigenbasis; see
# core/lowrank.py::ImplicitBasis and core/grams.py::GramComplement) --------


class _ImplicitScan(NamedTuple):
    """Driver-side bundle for the implicit low-rank scan path."""

    U_top: torch.Tensor  # (n, p_k)
    W_raw: torch.Tensor  # (n, c) unrotated covariates
    Y_raw: torch.Tensor  # (n, k) unrotated phenotypes
    eps: float
    n_total: int

    def context(self, ph: int):
        """(shared_raw, ImplicitCtx without per-SNP terms) of phenotype
        ``ph``: the lambda-independent raw Gram of [W, y], once per
        phenotype."""
        shared_raw = torch.cat([self.W_raw, self.Y_raw[:, ph:ph + 1]], dim=1)
        S_raw = _raw_gram(shared_raw)
        s = S_raw.shape[0]
        eps = torch.tensor(self.eps, dtype=S_raw.dtype, device=S_raw.device)
        # the per-SNP fields are filled per block; the null fit ignores them
        return shared_raw, ImplicitCtx(eps, self.n_total, S_raw,
                                       S_raw.new_zeros((1, s)),
                                       S_raw.new_zeros((1,)))


def _raw_gram(shared_raw: torch.Tensor) -> torch.Tensor:
    return pdot(shared_raw.T, shared_raw)


def _rotate_top(U_top: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """U_top' xb (p_k, B): the implicit scan's rotation of a block into the
    top space, its largest GEMM (the rotation kernel on the card,
    ops/rotate_kernel.py).  ``_rotate_top.count`` counts the calls, so a
    run can show how often each block was rotated; traced as a ``rotate``
    span, as core/eigen.py::rotate is."""
    _rotate_top.count += 1
    with profiling.span("rotate", U_top.device, r=U_top.shape[1],
                        n=U_top.shape[0], B=xb.shape[1]):
        return rotate_kernel.rotate(U_top, xb)


_rotate_top.count = 0


def _implicit_prep(U_top, shared_raw, xb):
    """Per-block top-space rotation + lambda-independent raw terms.

    Replaces the n x n rotation GEMM (core/eigen.py::rotate) with an
    n x p_k one plus an n x s raw cross GEMM: the only O(n) work the
    implicit scan does per block.
    """
    C_x = _rotate_top(U_top, xb)  # (p_k, B)
    vS_raw = pdot(xb.T, shared_raw)  # (B, s)
    vv_raw = torch.sum(xb * xb, dim=0)  # (B,)
    return C_x, vS_raw, vv_raw


def _implicit_multi_once(W_raw, Y_raw):
    """Phenotype-factored raw Gram pieces shared by the whole scan."""
    WtW = pdot(W_raw.T, W_raw)
    WtY = pdot(W_raw.T, Y_raw)
    YtY = torch.sum(Y_raw * Y_raw, dim=0)
    return WtW, WtY, YtY


def _implicit_multi_prep(U_top, W_raw, Y_raw, xb):
    """Per-block top-space rotation + factored raw terms (multi-pheno):
    one rotation serves every phenotype."""
    C_x = _rotate_top(U_top, xb)
    XtW = pdot(xb.T, W_raw)
    XtY = pdot(xb.T, Y_raw)
    vv = torch.sum(xb * xb, dim=0)
    return C_x, XtW, XtY, vv


@contextlib.contextmanager
def _prefill_overlap(X, block: int, device):
    """The opt-in background fill of the device block cache
    (``PYGEMMA_TPU_PREFETCH_OVERLAP=1``): while the body runs, a thread
    ships a file-backed PackedMatrix's blocks to the card, overlapping the
    kinship's decomposition.  On exit the fill is stopped and waited for,
    and an error it raised is raised here."""
    if not (os.environ.get("PYGEMMA_TPU_PREFETCH_OVERLAP", "0") == "1"
            and _cache_budget_bytes() > 0
            and isinstance(X, PackedMatrix)
            and X.cache_token is not None):
        yield
        return
    stop = threading.Event()
    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        fill = pool.submit(prefill_device_cache, X, block, stop, device)
        try:
            yield
        finally:
            stop.set()  # abandon blocks past what the scan needed
            fill.result()


def estimate_lambda(eigenVals, Y, W, restricted: bool = True,
                    grid: bool = False,
                    config: Optional[GwasConfig] = None,
                    device="cuda") -> float:
    """Variance-ratio estimate for a single design (rotated inputs).

    Public analogue of the reference's ``calc_lambda_restricted`` /
    ``calc_lambda`` entry points (pygemma_model.pyx:64, lmm/lmm.py:22-84):
    eigenVals (n,), Y (n,) outcome, W (n, q) design -- all already rotated
    into the kinship eigenbasis.
    """
    dev = resolve_device(device)
    cfg = (config or from_env()).replace(grid=grid)
    dtype = np.dtype(cfg.dtype)
    ev = torch.as_tensor(np.asarray(eigenVals, dtype).reshape(-1)).to(dev)
    Wd = torch.as_tensor(np.asarray(W, dtype)).to(dev)
    v = torch.as_tensor(np.asarray(Y, dtype).reshape(-1, 1)).to(dev)
    prob = LambdaProblem(ev, Wd, pair_products(Wd), v, v * v, Wd.shape[0],
                         Wd.shape[1], False, restricted)
    lam, _ = solve_lambda(prob, cfg)
    return float(lam[0])


def _kinship_fingerprint(Karr: np.ndarray, max_samples: int = 4096) -> str:
    """Content hash of K for the eigen-checkpoint key.

    Hashes a strided byte sample plus shape and dtype (for a
    :class:`LowRankKinship`, its own fingerprint bytes) -- the same bytes
    as ``pygemma_tpu.api._kinship_fingerprint``, so a run_dir eigen file
    written by either package is found by the other."""
    h = hashlib.blake2b(digest_size=16)
    if isinstance(Karr, LowRankKinship):
        h.update(b"lowrank|")
        h.update(Karr.fingerprint_bytes())
        return h.hexdigest()
    h.update(repr((Karr.shape, Karr.dtype.str)).encode())
    stride = max(1, int(np.ceil(np.sqrt(Karr.size / max_samples))))
    sample = np.ascontiguousarray(Karr[::stride, ::stride]) \
        if Karr.ndim == 2 else np.ascontiguousarray(Karr[::stride])
    h.update(sample.tobytes())
    return h.hexdigest()


def _host_pvalues(res: dict, n: int, c: int, tests) -> None:
    """Compute p-values on host in float64 with scipy for exact parity with
    the reference's ``stats.f.sf`` (lmm/lmm.py:482)."""
    df = n - c - 1
    res["p_wald"] = stats.f.sf(np.asarray(res["F_wald"], np.float64), 1, df)
    if "lrt" in tests:
        res["p_lrt"] = stats.chi2.sf(np.asarray(res.pop("D_lrt"), np.float64), 1)
    if "score" in tests:
        res["p_score"] = stats.f.sf(np.asarray(res.pop("F_score"), np.float64), 1, df)


def pygemma(
    Y,
    X,
    W=None,
    K=None,
    Z=None,
    snps: Optional[Sequence[str]] = None,
    verbose: int = 0,
    disable_checks: bool = True,
    de: bool = False,
    grid: bool = False,
    eigen: bool = True,
    nproc: Optional[int] = None,  # accepted for API parity
    tests: Optional[Sequence[str]] = None,
    config: Optional[GwasConfig] = None,
    run_dir: Optional[str] = None,
    mesh=None,
    device="cuda",
) -> pd.DataFrame:
    """Genome-wide LMM association scan (GEMMA method) on a torch device.

    Args mirror the reference driver (lmm/lmm.py:87-106):
      Y: (n,) or (n,1) phenotype (or (n,k): each column scanned in turn,
         results stacked with a ``pheno`` column).
      X: (n, p) genotype matrix: a float array, or a PackedMatrix /
         QuantizedMatrix whose codes stream to the device (float32 only).
      W: (n, c) covariates; None -> intercept only.
      K: (n, n) kinship, a LowRankKinship, or, when ``eigen=False``, the
         precomputed eigenvalue vector of K with X/Y/W already rotated.
      Z: optional loading matrix, K <- Z K Z' (lmm/lmm.py:124-125); needs a
         dense K.
      de: differential-expression mode -- swaps roles of x and y
         (lmm/lmm.py:498-532).
      grid: pure grid-search lambda (pygemma_model.pyx:99-132).
      tests: any of "wald", "lrt", "score".
      device: "cuda" (the default) or "cpu"; without a CUDA device the
         default raises instead of falling back.
      mesh: a (sample, snp) mesh of ranks from
         :func:`pygemma_tpu_torch.parallel.mesh.make_mesh`, whose device type
         is ``device``'s.  Every rank calls ``pygemma`` with the same
         arguments; each runs the scan on its share of every SNP block's
         columns on its own device, and all return the identical table.
         Replicated inputs (W, Y, the eigenbasis, the null fit) are rank 0's;
         rank 0 alone writes ``run_dir`` and logs.  A ``sample`` axis longer
         than 1 decomposes a dense K on its ranks together
         (:func:`~pygemma_tpu_torch.parallel.dist.sharded_eigh_fn`), for
         every ``eigh_backend`` but ``"host"``.
    """
    with profiling.span("pygemma") as call_span:
        dev = resolve_device(device)
        cfg = config or from_env()
        if grid:
            cfg = cfg.replace(grid=True)
        if tests is not None and tuple(tests) != cfg.tests:
            cfg = cfg.replace(tests=tuple(tests))
        _reject_unported(K, X, mesh)
        if mesh is not None:
            if rank_device(mesh).type != dev.type:
                raise ValueError(
                    f"the mesh's ranks run on {mesh.device_type}, "
                    f"not on device={device!r}")
            dev = rank_device(mesh)
        writer = is_writer(mesh)
        log = StageLogger(verbose)
        if mesh is not None:
            shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            log.log(f"mesh {shape} on {dev.type}, "
                    f"backend {torch.distributed.get_backend()}")

        dtype = np.dtype(cfg.dtype)
        Y = np.asarray(Y, dtype=dtype)
        if Y.ndim == 1:
            Y = Y[:, None]
        if isinstance(X, _STREAMED):
            # int8 / 2-bit codes stream to the device and dequantize there;
            # the float matrix never exists on the host
            if dtype != np.float32:
                raise ValueError(
                    "quantized genotype streaming is float32-only")
        else:
            X = np.asarray(X, dtype=dtype)
        n, p = X.shape
        W = np.ones((n, 1), dtype=dtype) if W is None else np.asarray(W, dtype)
        c = W.shape[1]

        if not disable_checks:
            for name, arr in (("X", X), ("Y", Y), ("W", W)):
                if isinstance(arr, _STREAMED):
                    # codes cannot hold NaN, but a corrupt affine sidecar (NaN
                    # mu, non-finite or non-positive sd) would spread NaN/Inf
                    # into every dequantized value
                    if (np.isnan(arr.mu).any()
                            or not np.all(np.isfinite(arr.sd))
                            or (arr.sd <= 0).any()):
                        raise ValueError(
                            f"invalid quantization sidecar on {name}: "
                            "mu must be finite and sd finite-positive")
                elif np.isnan(arr).any():
                    raise ValueError(f"NaNs present in {name}")

        def to_dev(a):
            return torch.as_tensor(np.asarray(a, dtype)).to(dev)

        def replicated(a):
            """A host input on this rank's device; under a mesh, rank 0's."""
            if mesh is None:
                return to_dev(a)
            return put_replicated(np.asarray(a, dtype), mesh)

        lowrank = isinstance(K, LowRankKinship)
        if Z is not None and eigen:
            if lowrank:
                raise ValueError("Z loading transform requires a dense K")
            K = loading_transform(to_dev(Z), to_dev(K)).cpu().numpy()

        ckpt = None
        eig_key = ""
        if eigen and K is not None:
            fingerprint = _kinship_fingerprint(K if lowrank else np.asarray(K))
            eig_key = f"{fingerprint}|{cfg.dtype}"
        done = None  # the run_dir's finished block keys
        if run_dir is not None:
            error = None
            if writer:  # under a mesh the run_dir is rank 0's alone
                ckpt = RunCheckpoint(run_dir)
                ckpt.clean_stale()
                # Saved blocks are only resumable under the same settings.
                run_meta = {"tests": list(cfg.tests), "grid": cfg.grid,
                            "dtype": cfg.dtype, "de": de,
                            "snp_block": cfg.snp_block}
                prev_meta = ckpt.load_meta()
                if prev_meta is None:
                    ckpt.save_meta(run_meta)
                elif prev_meta != run_meta:
                    error = (f"run_dir {run_dir} holds blocks computed with "
                             f"different settings ({prev_meta}); use a fresh "
                             f"run_dir for {run_meta}")
                done = set(ckpt.completed_blocks())
            if mesh is not None:
                error, done = distributed.broadcast_object((error, done))
            if error is not None:
                raise ValueError(error)
        if mesh is not None:
            eig_key = distributed.broadcast_object(eig_key)

        def eigen_basis(key, stage, compute, sharded=None):
            """(ev, U) on the device: from the device cache, the run_dir,
            or ``compute()``; the result becomes the device cache's one
            entry.  Under a mesh, rank 0 finds or computes it and broadcasts
            it, unless every rank holds it already; with ``sharded`` (a
            computation every rank joins, which leaves the same bytes on
            every rank), rank 0 only looks it up, and when it finds none
            every rank runs ``sharded()``.  Traced as an ``eigen`` span
            whose ``source`` says where the basis came from."""
            with profiling.span("eigen", dev) as sp:
                return _eigen_basis(key, stage, compute, sharded, sp)

        def _eigen_basis(key, stage, compute, sharded, sp):
            cache_key = (key, str(dev))
            hit = _EIGEN_DEV_CACHE.get(cache_key)
            sp.set(source="cache")
            if mesh is None and hit is not None:
                return hit
            if mesh is not None and distributed.all_true(hit is not None):
                return hit

            def computed(fn):
                sp.set(source="computed")
                with log.stage(stage):
                    ev_d, U_d = fn()
                if ckpt is not None:
                    ckpt.save_eigen(ev_d.cpu().numpy(), U_d.cpu().numpy(),
                                    key)
                return ev_d, U_d

            def obtain(fn):
                if hit is not None:
                    return hit
                cached = ckpt.load_eigen(key) if ckpt is not None else None
                if cached is not None:
                    sp.set(source="run_dir")
                    return to_dev(cached[0]), to_dev(cached[1])
                return computed(fn) if fn is not None else None

            if mesh is None:
                ev_d, U_d = obtain(compute)
            else:
                parts = obtain(compute if sharded is None else None) \
                    if writer else None
                if sharded is not None and not distributed.broadcast_object(
                        parts is not None):
                    ev_d, U_d = computed(sharded)
                else:
                    with log.stage("broadcast of the eigenbasis"):
                        ev_d, U_d = from_rank0(mesh, lambda: parts)
                    if not writer:
                        sp.set(source="rank0")
            ev_d = ev_d.to(torch_dtype(dtype))
            U_d = U_d.to(torch_dtype(dtype))
            _EIGEN_DEV_CACHE.clear()
            _EIGEN_DEV_CACHE[cache_key] = (ev_d, U_d)
            return ev_d, U_d

        B = min(cfg.snp_block, max(p, 1))
        if mesh is not None:
            # every rank of the snp axis takes an equal share of a block
            n_snp = axis_shard(mesh, cfg.snp_axis)[1]
            B = -(-B // n_snp) * n_snp
        # the opt-in fill of the device block cache overlaps the
        # decomposition (single-device runs only)
        with (_prefill_overlap(X, B, dev) if mesh is None
              else contextlib.nullcontext()):
            # --- eigendecomposition + rotation (lmm/lmm.py:151-167,
            # 243-246) ---
            impl = None  # _ImplicitScan when the implicit path is active
            if eigen and lowrank and cfg.lowrank_implicit is not False:
                def top_basis():
                    basis = lowrank_top_basis(K, cfg.eigh_backend,
                                              device=dev)
                    return basis.ev_top, basis.U_top

                ev_dev, U_top = eigen_basis(
                    eig_key + "|implicit",
                    "implicit low-rank eigendecomposition", top_basis)
                with log.stage("rotation of W, Y (top space)"):
                    W_raw, Y_raw = replicated(W), replicated(Y)
                    W_dev = rotate(U_top, W_raw)
                    Y_dev = rotate(U_top, Y_raw)
                U_dev = None  # no n x n basis exists on this path
                impl = _ImplicitScan(U_top, W_raw, Y_raw, float(K.eps), n)
            elif eigen:
                if lowrank:
                    def compute():
                        return lowrank_eigendecompose(K, cfg.eigh_backend,
                                                      dtype, device=dev)
                else:
                    def compute():
                        return auto_eigendecompose(np.asarray(K, dtype),
                                                   cfg.eigh_backend, dtype,
                                                   dev)
                sharded = None
                if (not lowrank and mesh is not None
                        and axis_shard(mesh, cfg.sample_axis)[1] > 1
                        and cfg.eigh_backend != "host"):
                    # the sample ranks decompose K's row slabs together
                    def sharded():
                        return sharded_eigh_fn(mesh, cfg)(
                            np.asarray(K, dtype))
                ev_dev, U_dev = eigen_basis(eig_key, "eigendecomposition",
                                            compute, sharded)
                with log.stage("rotation of W, Y"):
                    W_dev = rotate(U_dev, replicated(W))
                    Y_dev = rotate(U_dev, replicated(Y))
            else:
                ev_dev = torch.clamp_min(
                    replicated(np.asarray(K).reshape(-1)), 0.0)
                U_dev = None
                W_dev = replicated(W)
                Y_dev = replicated(Y)

            n_pheno = Y.shape[1]
            call_span.set(n=n, p=p, k=n_pheno,
                          path=("implicit" if impl is not None else
                                "rotated" if eigen else "prerotated"))
            # Batched multi-phenotype scan (eQTL-style workloads; the
            # reference runs a SLURM array per gene instead,
            # experiments/1000G/run_pyGEMMA.sh:43-52).  run_dir resumes per
            # phenotype, and a mesh gathers per phenotype, so both keep the
            # looped scan.
            if n_pheno >= 3 and run_dir is None and mesh is None:
                frames = _scan_phenos_batched(X, Y_dev, W_dev, ev_dev, U_dev,
                                              cfg, de, n, p, B, log, dev,
                                              impl)
            else:
                frames = _scan_phenos_looped(X, Y_dev, W_dev, ev_dev, U_dev,
                                             cfg, de, n, p, B, log, ckpt, dev,
                                             impl, mesh, done)
        results_df = (pd.concat(frames, ignore_index=True)
                      if len(frames) > 1 else frames[0])
        if snps is not None:
            results_df["SNPs"] = (
                list(snps) * n_pheno if n_pheno > 1 else list(snps)
            )
        return results_df


def _scan_phenos_looped(X, Y_dev, W_dev, ev_dev, U_dev, cfg, de, n, p, B,
                        log, ckpt, dev, impl: Optional[_ImplicitScan] = None,
                        mesh=None, done: Optional[set] = None):
    """One phenotype at a time.  ``done`` holds the run_dir's finished
    block keys (None without a run_dir; ``ckpt`` is None on ranks other
    than 0).  Under a mesh each rank streams and scans its share of every
    block's columns; the shares are gathered once a phenotype, or once a
    block with a run_dir, which rank 0 then writes."""
    n_pheno = Y_dev.shape[1]
    c = W_dev.shape[1]
    frames = []
    keys = _result_keys(cfg)
    shard = None if mesh is None else axis_shard(mesh, cfg.snp_axis)
    for ph in range(n_pheno):
        y_dev = Y_dev[:, ph]
        shared_raw = ictx = None
        if impl is not None:
            shared_raw, ictx = impl.context(ph)
        null_arr = None
        if ("lrt" in cfg.tests) or ("score" in cfg.tests):
            def fit():
                return (_fit_null(ev_dev, W_dev, y_dev, cfg, ictx),)

            with log.stage("null-model fit", "null_fit"):
                # under a mesh rank 0's, so D_lrt is the same on every rank
                (null_arr,) = fit() if mesh is None else from_rank0(mesh, fit)

        null_ml = float(null_arr[2]) if null_arr is not None else None

        def block_to_cols(stacked: np.ndarray, m: int) -> dict:
            """(n_keys, B) host array -> output-column dict for one block."""
            return _table_columns({k: row[:m] for k, row in zip(keys, stacked)},
                                  null_ml, cfg.tests)

        # the table's column names, from an empty block
        cols = {k: [] for k in block_to_cols(
            np.zeros((len(keys), 0), np.float32), 0)}

        # Results stay on the device until the scan has been dispatched (or
        # go to a writer thread when run_dir durability is on), so no pull
        # sits between blocks beyond the solver's own syncs.  A mesh with a
        # run_dir gathers each block in this thread: collectives never run
        # from the writer.
        pending = []  # (m, stacked device tensor) | ("blk", dict) | futures
        writer = cf.ThreadPoolExecutor(max_workers=1) if ckpt else None

        def _pull_save(start_, m_, stacked_):
            blk = block_to_cols(stacked_.cpu().numpy(), m_)
            ckpt.save_block(ph * p + start_, blk)
            return blk

        def _save(start_, blk):
            ckpt.save_block(ph * p + start_, blk)
            return blk

        try:
            with log.stage(f"association scan ({p} SNPs, n={n})", "scan"):
                streamer = SnpBlockStreamer(X, B, dtype=X.dtype, device=dev,
                                            shard=shard)
                for start, stop, xb_dev in log.track(
                        streamer, "Testing SNPs...", total=-(-p // B)):
                    m = stop - start
                    if done is not None and ph * p + start in done:
                        blk = (ckpt.load_block(ph * p + start)
                               if ckpt is not None else None)
                        if mesh is not None:
                            blk = distributed.broadcast_object(blk)
                        pending.append(("blk", blk))
                        continue
                    with profiling.span("block", start=start, stop=stop):
                        block_ctx = None
                        if impl is not None:
                            xb_dev, vS_raw, vv_raw = _implicit_prep(
                                impl.U_top, shared_raw, xb_dev)
                            block_ctx = ictx._replace(vS_raw=vS_raw,
                                                      vv_raw=vv_raw)
                        elif U_dev is not None:
                            xb_dev = rotate(U_dev, xb_dev)
                        stacked = _assoc_block(ev_dev, W_dev, y_dev, xb_dev,
                                               cfg, null_arr, de, block_ctx)
                        if done is None:
                            pending.append((m, stacked))
                        elif mesh is None:
                            pending.append(writer.submit(_pull_save, start,
                                                         m, stacked))
                        else:
                            blk = block_to_cols(gather_columns(
                                [stacked], mesh, cfg.snp_axis, m), m)
                            pending.append(writer.submit(_save, start, blk)
                                           if writer is not None
                                           else ("blk", blk))

                with profiling.span("table"):
                    if mesh is not None and done is None:
                        # one gather of every block's shares
                        pending = [("blk", block_to_cols(gather_columns(
                            [t for _, t in pending], mesh, cfg.snp_axis, p),
                            p))]
                    for item in pending:
                        if isinstance(item, tuple) and item[0] == "blk":
                            blk = item[1]
                        elif isinstance(item, tuple):
                            blk = block_to_cols(item[1].cpu().numpy(),
                                                item[0])
                        else:
                            blk = item.result()  # writer future
                        for k in cols:
                            cols[k].append(blk[k])
                    out = {k: np.concatenate(v) if v else np.array([])
                           for k, v in cols.items()}
                    frames.append(_frame(out, n, c, cfg.tests,
                                         ph if n_pheno > 1 else None))
        finally:
            if writer is not None:
                writer.shutdown()

    return frames


def _scan_phenos_batched(X, Y_dev, W_dev, ev_dev, U_dev, cfg, de, n, p, B,
                         log, dev, impl: Optional[_ImplicitScan] = None):
    """All phenotypes per block: each block streams once and is rotated
    (dense K) or prepared in the top space (implicit K) once, then the k
    phenotypes run on it, each with the fused kernel where ``_use_fused``
    takes it.  Results stay on the device until every block is dispatched.

    With ``impl`` the per-phenotype raw Gram terms factor into shared
    W-blocks plus one cross column each (:class:`ImplicitMultiCtx`).

    The block is the looped scan's ``B``: the JAX package shrinks it by k
    on its vmapped path to bound (k, B, n) temporaries, which a loop over
    phenotypes never makes; the table does not depend on the block size.
    """
    n_pheno = Y_dev.shape[1]
    c = W_dev.shape[1]
    Y_kn = Y_dev.T  # (k, n), or (k, p_k) on the implicit path
    base = None
    if impl is not None:
        WtW, WtY, YtY = _implicit_multi_once(impl.W_raw, impl.Y_raw)
        eps = torch.tensor(impl.eps, dtype=WtW.dtype, device=WtW.device)
        # the per-block fields are filled per block; the null fit ignores them
        base = ImplicitMultiCtx(eps, impl.n_total, WtW, WtY, YtY,
                                WtW.new_zeros((1, c)),
                                WtW.new_zeros((1, n_pheno)),
                                WtW.new_zeros((1,)))
    null_stack = None
    if ("lrt" in cfg.tests) or ("score" in cfg.tests):
        with log.stage(f"null-model fits ({n_pheno} phenotypes)",
                       "null_fit"):
            null_stack = fit_null_multi(ev_dev, W_dev, Y_kn, cfg, base)

    keys = _result_keys(cfg)
    pending = []  # (m, stacked (n_keys, k, B) device tensor)
    frames = []
    with log.stage(
            f"association scan ({p} SNPs x {n_pheno} phenotypes, n={n})",
            "scan"):
        streamer = SnpBlockStreamer(X, B, dtype=X.dtype, device=dev)
        for start, stop, xb_dev in log.track(
                streamer, "Testing SNPs...", total=-(-p // B)):
            with profiling.span("block", start=start, stop=stop):
                ictx = None
                if impl is not None:
                    xb_dev, XtW, XtY, vv = _implicit_multi_prep(
                        impl.U_top, impl.W_raw, impl.Y_raw, xb_dev)
                    ictx = base._replace(XtW=XtW, XtY=XtY, vv=vv)
                elif U_dev is not None:
                    xb_dev = rotate(U_dev, xb_dev)
                pending.append((stop - start, _assoc_multi(
                    ev_dev, W_dev, Y_kn, xb_dev, cfg, null_stack, de, ictx)))
        with profiling.span("table"):
            host = [(m, stacked.cpu().numpy()) for m, stacked in pending]
            full = {k: np.concatenate([h[i, :, :m] for m, h in host], axis=1)
                    for i, k in enumerate(keys)}  # (k, p) each
            null_host = (null_stack.cpu().numpy()
                         if null_stack is not None else None)
            for ph in range(n_pheno):
                null_ml = (float(null_host[ph, 2])
                           if null_host is not None else None)
                out = _table_columns({k: v[ph] for k, v in full.items()},
                                     null_ml, cfg.tests)
                frames.append(_frame(out, n, c, cfg.tests, ph))
    return frames
