"""Fused per-SNP-lambda Gram statistics: the hand-written CUDA kernel K1.

The per-SNP-lambda evaluation (bisection/Newton refinement,
:func:`pygemma_tpu_torch.core.grams.grams_per_snp_lambda`) materializes
(n, B) weight matrices d^k = (lam_b*Lambda_i + 1)^-k in device memory as
matmul operands for k = 1, 2, 3.  ``csrc/gram_kernel.cu`` computes the same
sums with d^k kept in registers and the sums over samples on the tensor
cores in 3xTF32, and evaluates R lambda values per SNP (the solver's root
slots) in the same launch.  It replaces the Pallas TPU kernel
``pygemma_tpu/ops/gram_kernel.py::_kernel``; the source says what bounds it
on the card and how its design answers that.

:func:`fused_grams` is the wrapper with the JAX package's ``fused_grams``
contract (return shapes, ascending k, float32 outputs even for float64
inputs).  On a CUDA tensor it launches the kernel, or raises; on a CPU
tensor it runs :func:`fused_grams_reference`, the kernel's plain PyTorch
version.  ``fused_grams.launches`` counts kernel launches; with tracing on
(utils/profiling.py) each launch is a ``k1`` span with its shape.

The kernel is built at first use with ``nvcc`` into ``_build/`` (listed in
.gitignore) and bound with ``ctypes``: no PyTorch headers, so a build takes
seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import torch

from ..core.grams import grams_per_snp_lambda, index_tensor, pair_index
from ..utils import profiling

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "gram_kernel.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: each sample-axis split covers at least this many samples
_MIN_SPAN = 256
#: ... and at most this many: the tensor cores' accumulation into a
#: split's sums loses about half an ulp of the sum per addition, so their
#: error grows with the split's length (on the card, 2e-5 of the largest
#: sum at 2,048 samples; k1_ablation.py)
_MAX_SPAN = 1024
#: device kernels of one fused_grams call, as a profiler names them
KERNEL_NAMES = ("k1_partials_kernel", "k1_reduce_kernel")

_libs = {}  # (source, defines) -> bound library


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels of csrc/")


def build(verbose: bool = False, defines: Tuple[str, ...] = (),
          source: Path = SOURCE) -> Path:
    """Compile a kernel source of ``csrc/`` (K1's by default; once per
    source content and flags) into a shared library and return its path.
    ``defines`` are macros passed with ``-D``: K1's measurement switches,
    which the wrapper's own library never sets, or the REML kernel's Gram
    size."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    src = source.read_bytes()
    tag = hashlib.blake2b(src + " ".join(flags).encode(),
                          digest_size=8).hexdigest()
    lib_path = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *flags, "-o", tmp, str(source)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr)
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half
    return lib_path


def bind(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C interface.  Its
    ``geometry`` is the source's launch layout: (columns per block,
    [pairs | 1] features per block, shared features per block, samples per
    pipeline stage)."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gram_fused_launch.argtypes = [p, p, p, p, p, p, p] + [i] * 9 + [p]
    lib.gram_fused_launch.restype = i
    lib.gram_blocks_per_sm.argtypes = [i]
    lib.gram_blocks_per_sm.restype = i
    geometry = []
    for name in ("gram_columns_per_block", "gram_base_features_per_block",
                 "gram_shared_features_per_block", "gram_sample_tile"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
        geometry.append(getattr(lib, name)())
    lib.geometry = tuple(geometry)
    lib.blocks_per_sm = {}  # kmax -> resident blocks per SM
    return lib


def _load(source: Path = SOURCE, binder=None,
          defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and bind a kernel library once per process:
    K1's by default, bound by :func:`bind`; another source with its own
    ``binder``."""
    key = (source, defines)
    if key not in _libs:
        _libs[key] = (binder or bind)(build(defines=defines, source=source))
    return _libs[key]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _blocks_per_sm(lib: ctypes.CDLL, kmax: int) -> int:
    if kmax not in lib.blocks_per_sm:
        nb = lib.gram_blocks_per_sm(kmax)
        if nb <= 0:
            raise RuntimeError(f"gram kernel occupancy query failed: {nb}")
        lib.blocks_per_sm[kmax] = nb
    return lib.blocks_per_sm[kmax]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def feature_blocks(m: int, s: int, base_per_block: int,
                   shared_per_block: int) -> int:
    """Blocks over the features: block z holds [pairs | 1] features
    [base_per_block z, base_per_block (z + 1)) and shared features
    [shared_per_block z, shared_per_block (z + 1)), zero-padded."""
    return max(_cdiv(m + 1, base_per_block), _cdiv(s, shared_per_block))


def launch_plan(n: int, B: int, R: int, m: int, s: int, kmax: int,
                sm_count: int, blocks_per_sm: int,
                geometry: Tuple[int, int, int, int]) -> Tuple[int, int, int]:
    """(nsplit, span, rows): how the sample axis is split over blocks, for
    a library's ``geometry`` (see :func:`bind`).

    The (SNP, slot) columns give ceil(B*R / columns per block) blocks,
    times the feature blocks; the sample axis is split into as many parts
    as still fit the card in one wave of resident blocks, with at least
    ``_MIN_SPAN`` samples (a whole number of stages) per split, and into
    more when a split would exceed ``_MAX_SPAN``."""
    cols, base_per_block, shared_per_block, tile = geometry
    rows = kmax * (m + s + 2) + 1
    col_blocks = (_cdiv(B * R, cols)
                  * feature_blocks(m, s, base_per_block, shared_per_block))
    fit = blocks_per_sm * sm_count // col_blocks
    nsplit = max(1, min(fit, _cdiv(n, _MIN_SPAN)), _cdiv(n, _MAX_SPAN))
    span = _cdiv(_cdiv(n, nsplit), tile) * tile
    return _cdiv(n, span), span, rows


def launch(lib: ctypes.CDLL, lam, ev, pairs, shared, v, kmax: int,
           want_logh: bool, span: int = None):
    """Launch the kernel of ``lib`` on contiguous CUDA float32 inputs
    (``lam`` is (B, R)) and return the (rows, B, R) sums.  ``span`` sets
    the samples per split in place of :func:`launch_plan`'s (a whole
    number of stages; k1_ablation.py uses it to see how the rounding of
    the sums depends on the split's length)."""
    B, R = lam.shape
    n, m = pairs.shape
    s = shared.shape[1]
    index = v.device.index
    if index is None:
        index = torch.cuda.current_device()
    dev = torch.device("cuda", index)
    # the library's occupancy query, its stream and its <<<>>> launch all
    # act on the thread's current device: make it the tensors' own
    with torch.cuda.device(index):
        nsplit, plan_span, rows = launch_plan(
            n, B, R, m, s, kmax, _sm_count(index), _blocks_per_sm(lib, kmax),
            lib.geometry)
        if span is not None:
            if span <= 0 or span % lib.geometry[3]:
                raise ValueError(f"span must be a positive multiple of "
                                 f"{lib.geometry[3]}, got {span}")
            nsplit, plan_span = _cdiv(n, span), span
        part = torch.empty((nsplit, rows, B * R), dtype=torch.float32,
                           device=dev)
        out = torch.empty((rows, B, R), dtype=torch.float32, device=dev)
        args = (lam.data_ptr(), ev.data_ptr(), pairs.data_ptr(),
                shared.data_ptr(), v.data_ptr(), part.data_ptr(),
                out.data_ptr(), n, B, R, m, s, kmax, int(want_logh), nsplit,
                plan_span, torch.cuda.current_stream(dev).cuda_stream)
        with profiling.span("k1", dev, n=n, B=B, R=R, m=m, s=s, kmax=kmax,
                            want_logh=bool(want_logh)):
            err = lib.gram_fused_launch(*args)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {err}")
    fused_grams.launches += 1
    return out


def _split_rows(out, m, s, kmax, want_logh):
    """(rows, B, R) kernel rows -> the fused_grams tuple with (B, R) lead."""
    F = m + s + 2
    X = out[:kmax * F].unflatten(0, (kmax, F))  # (kmax, F, B, R)
    S = X[:, :m].permute(2, 3, 0, 1)  # (B, R, kmax, m)
    sum_d = X[0, m]
    sum_d2 = X[1, m] if kmax >= 2 else torch.zeros_like(sum_d)
    vS = X[:, m + 1:m + 1 + s].permute(2, 3, 0, 1)  # (B, R, kmax, s)
    vv = X[:, m + 1 + s].permute(1, 2, 0)  # (B, R, kmax)
    sum_logh = out[kmax * F] if want_logh else torch.zeros_like(sum_d)
    return S, vS, vv, sum_d, sum_d2, sum_logh


def fused_grams_reference(lam, ev, pairs, shared, v, kmax: int,
                          want_logh: bool = False, dtype=torch.float32):
    """Plain PyTorch version of the kernel, with :func:`fused_grams`'s
    contract, built on :func:`grams_per_snp_lambda`.  It computes in
    ``dtype``: float32 is the kernel's contract; float64 gives the
    yardstick both are measured against on the card."""
    lam, ev, pairs, shared, v = (t.to(dtype)
                                 for t in (lam, ev, pairs, shared, v))
    squeeze = lam.ndim == 1
    if squeeze:
        lam = lam[:, None]
    s = shared.shape[1]
    iu, ju = pair_index(s)
    dev = str(v.device)
    flat = index_tensor(tuple((iu * s + ju).tolist()), dev)
    ks = tuple(range(1, kmax + 1))
    parts = []
    for r in range(lam.shape[1]):
        grams, sums = grams_per_snp_lambda(lam[:, r], ev, shared, pairs, v,
                                           v * v, ks, want_logh=want_logh)
        A = torch.stack(grams, dim=1)  # (B, kmax, t, t)
        S = A[..., :s, :s].reshape(A.shape[:2] + (s * s,)).index_select(-1, flat)
        sum_d2 = sums.sum_d2 if kmax >= 2 else torch.zeros_like(sums.sum_d)
        parts.append((S, A[..., :s, s], A[..., s, s], sums.sum_d, sum_d2,
                      sums.sum_logh))
    if squeeze:
        return parts[0]
    return tuple(torch.stack([p[i] for p in parts], dim=1) for i in range(6))


def fused_grams(
    lam: torch.Tensor,  # (B,) or (B, R)
    ev: torch.Tensor,  # (n,)
    pairs: torch.Tensor,  # (n, m) WITHOUT the ones column
    shared: torch.Tensor,  # (n, s)
    v: torch.Tensor,  # (n, B) per-SNP genotype columns
    kmax: int,
    want_logh: bool = False,
):
    """Returns (S (B[,R],kmax,m), vS (B[,R],kmax,s), vv (B[,R],kmax),
    sum_d, sum_d2, sum_logh), float32.  A 2-D ``lam`` evaluates R lambda
    slots per SNP in one pass.  ``sum_d2`` is zero when ``kmax`` is 1 and
    ``sum_logh`` is zero unless ``want_logh``."""
    if not 1 <= kmax <= 3:
        raise ValueError(f"kmax must be 1, 2 or 3, got {kmax}")
    devs = {t.device for t in (lam, ev, pairs, shared, v)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return fused_grams_reference(lam, ev, pairs, shared, v, kmax,
                                     want_logh)
    if dev.type != "cuda":
        raise ValueError(f"fused_grams runs on CUDA or CPU tensors, not {dev}")
    n, B = v.shape
    if ev.shape != (n,) or pairs.shape[0] != n or shared.shape[0] != n:
        raise ValueError("ev, pairs, shared and v must share the sample axis")
    s = shared.shape[1]
    if pairs.shape[1] != s * (s + 1) // 2:
        raise ValueError("pairs must hold the s(s+1)/2 pair products")
    squeeze = lam.ndim == 1
    lam2 = lam[:, None] if squeeze else lam
    if lam2.shape[0] != B:
        raise ValueError(f"lam has {lam2.shape[0]} rows for {B} SNP columns")
    args = (t.to(torch.float32).contiguous()
            for t in (lam2, ev, pairs, shared, v))
    out = launch(_load(), *args, kmax, want_logh)
    res = _split_rows(out, pairs.shape[1], s, kmax, want_logh)
    if squeeze:
        return tuple(t.squeeze(1) for t in res)
    return res


fused_grams.launches = 0


def flops_and_bytes(n: int, B: int, R: int, m: int, s: int, kmax: int,
                    want_logh: bool) -> Tuple[float, float]:
    """Work of one fused_grams call: (floating-point operations, bytes).

    Per (sample, column): h (2), d (1), the powers (kmax-1), v*v (1), and
    per k one multiply d^k*v plus a multiply-add for each of the m+1 pair
    features, the s shared features and the v*v feature (kmax *
    (2*(m+s+2) + 1)); log h and its sum (2) when wanted.  Bytes: each input
    read once and each output written once, float32."""
    per = 2 + 1 + (kmax - 1) + 1 + kmax * (2 * (m + s + 2) + 1)
    if want_logh:
        per += 2
    flops = float(per) * n * B * R
    out_vals = B * R * (kmax * (m + s + 1) + 3)
    in_vals = B * R + n + n * m + n * s + n * B
    return flops, 4.0 * (in_vals + out_vals)


def tensor_core_work(n: int, B: int, R: int, m: int, s: int, kmax: int,
                     want_logh: bool) -> Tuple[float, float, float]:
    """The same work as the tensor-core design does it: (FP32-pipe
    operations, TF32 tensor-core operations, bytes).

    The products with the m+1 pair features and the s shared features are
    three TF32 passes each (2 * 3 * kmax * (m+s+1) per (sample, column)).
    The rest stays on the FP32 pipes: h (2), d (1), the powers (kmax-1),
    v*v (1), per k d^k*v (1) and the vv multiply-add (2); log h and its sum
    (2) when wanted."""
    per = 2 + 1 + (kmax - 1) + 1 + 3 * kmax + (2 if want_logh else 0)
    cols = float(n) * B * R
    tf32 = 2.0 * 3 * kmax * (m + s + 1) * cols
    return per * cols, tf32, flops_and_bytes(n, B, R, m, s, kmax,
                                             want_logh)[1]


def bound_ms(flops: float, nbytes: float, peak_flops: float = 67e12,
             peak_bytes: float = 3.35e12, tf32_flops: float = 0.0,
             peak_tf32: float = 495e12) -> Tuple[float, str]:
    """Least time (ms) the card could take, and which resource sets it:
    the largest of the FP32-pipe operations, the TF32 tensor-core
    operations and the bytes over their H100 SXM data-sheet peaks (FP32
    without tensor cores, dense TF32, HBM3)."""
    t_ops = max(flops / peak_flops, tf32_flops / peak_tf32) * 1e3
    t_bytes = nbytes / peak_bytes * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
