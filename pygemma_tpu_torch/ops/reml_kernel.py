"""The REML kernel: one launch per lambda evaluation of the REML / ML search.

After the Gram builders (:mod:`pygemma_tpu_torch.core.grams`, K1 in
:mod:`pygemma_tpu_torch.ops.gram_kernel`), an evaluation is per-SNP scalar
algebra on (t, t) Grams, t = q + 1: the implicit complement, the
[W, x, y] permutation, a small Cholesky, the Woodbury scalars, d1 / d2 /
the likelihood (:mod:`pygemma_tpu_torch.core.reml`), then the search's
step (:mod:`pygemma_tpu_torch.core.solver`).  In PyTorch that is about 240
tiny launches an evaluation.  ``csrc/reml_kernel.cu`` does it in one, one
thread per lane; the source says why it was added (it replaces no TPU
kernel), what bounds it and how its design answers that.

:func:`reml_kernel` launches it on float32 or float64 CUDA tensors, or
raises; ``reml_kernel.launches`` counts the launches.  Its plain version is
the core's own code, :func:`pygemma_tpu_torch.core.solver.evaluate_plain`,
and :func:`pygemma_tpu_torch.core.solver.algebra` picks between them: the
kernel for tensors on the card, the plain version on the CPU.

What a call computes (``need``; ``packed`` holds rows k = 1..K):

- ``"d1"``: d ell / d lambda (K >= 2); with a bisection ``step``
  (:class:`pygemma_tpu_torch.core.solver.Bisect`) the step instead, in
  place;
- ``"newton"``: (d1, d2) (K >= 3); with a Newton ``step``
  (:class:`pygemma_tpu_torch.core.solver.Newton`) the safeguarded step
  instead, in place on ``lam`` and ``step.done``;
- ``"lik"``: the (restricted) log-likelihood (K >= 1, the sums with
  log h), -inf where ``valid`` is False;
- ``"wald"``: the Wald statistics at lambda* (K >= 1): a (5, B) stack of
  beta, se, tau, lambda and F (NaN rows where x is collinear with W) and
  the (B,) mask x'P x > MIN_VAL.

Lanes: the packed parts' leading axes, (B,) for a per-SNP or a scalar
lambda, (G, B) for a lambda grid (``lam`` (G,)).  Steps and ``valid`` take
(B,) lanes.

The library is built at first use with ``nvcc``, one per Gram size and
float type (the source's ``REML_T`` and ``REML_F``), by
:func:`pygemma_tpu_torch.ops.gram_kernel.build`, and bound with
``ctypes``.  Grams up to :data:`T_MAX` live in registers; a wider one keeps
its Cholesky factor and M G_2 in local memory, 2 (t - 1)^2 values a lane,
which CUDA reserves for every thread the card can hold.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from ..core import reml
from ..core.grams import GramComplement, PackedGrams
from . import gram_kernel

SOURCE = Path(gram_kernel.__file__).resolve().parent.parent / "csrc" / \
    "reml_kernel.cu"
#: the widest Gram held in registers, t = q + 1: up to 14 covariates with
#: the predictor and the outcome (the source's T_MAX); wider ones build the
#: same code with its loops kept
T_MAX = 16
#: the source's Mode values
MODES = {"d1": 0, "bisect": 1, "newton": 2, "lik": 3, "wald": 4}
#: the Gram rows each need reads
KMAX = {"d1": 2, "newton": 3, "lik": 1, "wald": 1}
#: the float types the kernel takes, as the source's REML_F
FLOATS = {torch.float32: "float", torch.float64: "double"}
#: a step's mode after its evaluation
_STEP_MODES = {"d1": "bisect", "newton": "newton"}


class _View(ctypes.Structure):
    """The source's View: element (g, b, k, j) at p[g sg + b sb + k sk +
    j sj]."""

    _fields_ = [("p", ctypes.c_void_p)] + [
        (f, ctypes.c_longlong) for f in ("sg", "sb", "sk", "sj")]


class _Args(ctypes.Structure):
    """The source's Args, field for field."""

    _fields_ = (
        [(f, _View) for f in ("S", "vS", "vv", "sum_d", "sum_d2", "sum_logh",
                              "lam", "R_S", "R_vS", "R_vv")]
        + [(f, ctypes.c_void_p) for f in ("eps", "lo", "hi", "flo", "lo0",
                                          "hi0", "done", "lam_out", "valid",
                                          "out", "ok")]
        + [(f, ctypes.c_int) for f in ("G", "B", "n", "n_comp", "mode",
                                       "restricted", "permute")]
        + [(f, ctypes.c_double) for f in ("rtol", "lik_const", "sqrt_df")])


def bind(path: Path, t: Optional[int] = None,
         itemsize: Optional[int] = None) -> ctypes.CDLL:
    """Load a built REML kernel library, declare its C interface and check
    that its argument block, its width bound and (given ``t`` and
    ``itemsize``) its Gram size and float size are the wrapper's."""
    lib = ctypes.CDLL(str(path))
    for name in ("reml_t_max", "reml_t", "reml_f_bytes", "reml_args_bytes"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.reml_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.reml_launch.restype = ctypes.c_int
    if lib.reml_args_bytes() != ctypes.sizeof(_Args):
        raise RuntimeError(f"{path.name}: argument block of "
                           f"{lib.reml_args_bytes()} bytes, the wrapper's "
                           f"is {ctypes.sizeof(_Args)}")
    if lib.reml_t_max() != T_MAX:
        raise RuntimeError(f"{path.name}: T_MAX {lib.reml_t_max()}, the "
                           f"wrapper's is {T_MAX}")
    if t is not None and lib.reml_t() != t:
        raise RuntimeError(f"{path.name}: built for Grams of size "
                           f"{lib.reml_t()}, not {t}")
    if itemsize is not None and lib.reml_f_bytes() != itemsize:
        raise RuntimeError(f"{path.name}: built for {lib.reml_f_bytes()}-"
                           f"byte floats, not {itemsize}")
    return lib


def _load(t: int, dtype: torch.dtype) -> ctypes.CDLL:
    """The library for Grams of size ``t`` in ``dtype`` (built once per
    size and type)."""
    return gram_kernel._load(
        SOURCE, functools.partial(bind, t=t, itemsize=dtype.itemsize),
        (f"REML_T={t}", f"REML_F={FLOATS[dtype]}"))


def _view(x: torch.Tensor, lanes, tail=()) -> _View:
    """``x`` broadcast to ``lanes + tail`` as a View over (g, b, k, j): no
    copy, a broadcast axis has stride 0.  (B,) lanes take g = 0."""
    shape = tuple(lanes) + tuple(tail)
    lead = len(shape) - x.dim()
    if lead < 0 or any(d not in (1, n) for d, n in zip(x.shape,
                                                        shape[lead:])):
        raise ValueError(f"{tuple(x.shape)} does not broadcast to {shape}")
    st = [0] * lead + [s if d == n else 0 for d, n, s in
                       zip(x.shape, shape[lead:], x.stride())]
    if len(lanes) == 1:
        st.insert(0, 0)
    return _View(x.data_ptr(), *(st + [0] * (4 - len(st))))


def kernel_args(need: str, packed: PackedGrams, lam, *, n: int, q: int,
                permute: bool, restricted: bool = True,
                comp: Optional[GramComplement] = None, step=None,
                valid=None):
    """Check the inputs of one launch and return (``_Args``, t, the float
    type, the outputs, the tensors the launch reads).  The checks are the
    kernel's; the tensors' device is :func:`reml_kernel`'s to check.  A
    step is read by its fields: ``lo``, ``hi``, ``flo`` after "d1";
    ``lo0``, ``hi0``, ``done``, ``rtol`` after "newton"."""
    if need not in KMAX:
        raise ValueError(f"need must be one of {sorted(KMAX)}, got {need!r}")
    mode = need
    if step is not None:
        if need not in _STEP_MODES:
            raise ValueError(f"a step follows a 'd1' or a 'newton' "
                             f"evaluation, not {need!r}")
        mode = _STEP_MODES[need]
    s = packed.vS.shape[-1]
    if q != s:
        raise ValueError(f"the design's width q = {q} must equal the shared "
                         f"columns' count {s} (t = q + 1 = s + 1)")
    t = q + 1
    K = packed.vv.shape[-1]
    if K < KMAX[need]:
        raise ValueError(f"{need!r} reads Gram rows k = 1..{KMAX[need]}; "
                         f"the packed parts hold {K}")
    lanes = tuple(packed.vv.shape[:-1])
    if len(lanes) == 2:
        if lam.shape != lanes[:1]:
            raise ValueError(f"(G, B) lanes take a (G,) lambda grid, not "
                             f"{tuple(lam.shape)}")
        lam_l = lam[:, None]
        if need == "wald" or step is not None or valid is not None:
            raise ValueError(f"{need!r} with a step, a mask or the Wald "
                             "statistics takes (B,) lanes")
    elif len(lanes) == 1:
        lam_l = lam
    else:
        raise ValueError(f"lanes must be (B,) or (G, B), not {lanes}")
    G, B = (1,) + lanes if len(lanes) == 1 else lanes
    if len(lanes) == 1 and lam.shape not in ((), (B,)):
        raise ValueError(f"(B,) lanes take a scalar or a (B,) lambda, not "
                         f"{tuple(lam.shape)}")
    if packed.S.shape[-1] != s * (s + 1) // 2:
        raise ValueError("S must hold the s(s+1)/2 pair sums")
    floats = [packed.S, packed.vS, packed.vv, *packed.sums, lam]
    masks = [] if valid is None else [valid]
    lane_state = list(masks)  # (B,) tensors the kernel indexes by SNP
    args = _Args()
    args.S = _view(packed.S, lanes, (K, s * (s + 1) // 2))
    args.vS = _view(packed.vS, lanes, (K, s))
    args.vv = _view(packed.vv, lanes, (K,))
    args.sum_d, args.sum_d2, args.sum_logh = (_view(x, lanes)
                                              for x in packed.sums)
    args.lam = _view(lam_l, lanes)
    if valid is not None:
        args.valid = valid.data_ptr()
    if comp is not None:
        if comp.R_vS.shape != (B, s) or comp.R_vv.shape != (B,) \
                or comp.R_S.shape != (s, s) or comp.eps.shape != ():
            raise ValueError(f"the complement holds residuals of shapes "
                             f"{tuple(comp.R_vS.shape)}, "
                             f"{tuple(comp.R_vv.shape)} for a block of {B}")
        args.R_S = _View(comp.R_S.data_ptr(), 0, 0, *comp.R_S.stride())
        args.R_vS = _View(comp.R_vS.data_ptr(), 0, comp.R_vS.stride(0), 0,
                          comp.R_vS.stride(1))
        args.R_vv = _View(comp.R_vv.data_ptr(), 0, comp.R_vv.stride(0), 0, 0)
        args.eps = comp.eps.data_ptr()
        args.n_comp = comp.n_comp
        floats += [comp.eps, comp.R_S, comp.R_vS, comp.R_vv]
    if mode == "bisect":
        args.lo, args.hi = step.lo.data_ptr(), step.hi.data_ptr()
        args.flo = step.flo.data_ptr()
        floats += [step.lo, step.hi, step.flo]
        lane_state += [step.lo, step.hi, step.flo, lam]
    elif mode == "newton" and step is not None:
        args.lo0, args.hi0 = step.lo0.data_ptr(), step.hi0.data_ptr()
        args.done = step.done.data_ptr()
        args.rtol = step.rtol
        floats += [step.lo0, step.hi0]
        masks += [step.done]
        lane_state += [step.lo0, step.hi0, step.done, lam]
    if step is not None:
        args.lam_out = lam.data_ptr()  # the next midpoint, or the Newton
        # iterate, written over the lambda the lane was evaluated at
    for x in lane_state:
        if x.shape != (B,) or not x.is_contiguous():
            raise ValueError(f"step state and masks must be contiguous "
                             f"({B},) tensors, not {tuple(x.shape)}")
    dtype = packed.vv.dtype
    if dtype not in FLOATS:
        raise ValueError(f"the REML kernel takes float32 or float64 "
                         f"tensors, not {dtype}")
    for x in floats:
        if x.dtype != dtype:
            raise ValueError(f"the REML kernel takes tensors of one float "
                             f"type, not {dtype} and {x.dtype}")
    for x in masks:
        if x.dtype != torch.bool:
            raise ValueError(f"masks must be bool, not {x.dtype}")
    dev = packed.vv.device
    if need == "wald":
        outs = (torch.empty((5, B), dtype=dtype, device=dev),
                torch.empty((B,), dtype=torch.bool, device=dev))
        args.ok = outs[1].data_ptr()
    elif step is not None:
        outs = ()
    else:
        shape = ((2,) if need == "newton" else ()) + lanes
        outs = (torch.empty(shape, dtype=dtype, device=dev),)
    if outs:
        args.out = outs[0].data_ptr()
    args.G, args.B, args.n = G, B, n
    args.mode = MODES[mode]
    args.restricted, args.permute = int(restricted), int(permute)
    if need == "lik":
        args.lik_const = (reml.restricted_const(n, q) if restricted
                          else reml.ml_const(n))
    if need == "wald":
        args.sqrt_df = math.sqrt(float(n - q))
    return args, t, dtype, outs, floats + masks


def reml_kernel(need: str, packed: PackedGrams, lam, *, n: int, q: int,
                permute: bool, restricted: bool = True,
                comp: Optional[GramComplement] = None, step=None,
                valid=None):
    """One evaluation (and step) over every lane in one launch on float32
    or float64 CUDA tensors; raises on anything else.  Returns d1 (lanes),
    (d1, d2) (2, lanes), the likelihood (lanes), None after a step, or the
    Wald stack and mask (see the module docstring)."""
    args, t, dtype, outs, tensors = kernel_args(
        need, packed, lam, n=n, q=q, permute=permute, restricted=restricted,
        comp=comp, step=step, valid=valid)
    devs = {x.device for x in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"the REML kernel runs on tensors of one CUDA "
                         f"device, not {devs}")
    dev = devs.pop()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        lib = _load(t, dtype)
        err = lib.reml_launch(ctypes.byref(args),
                              torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"REML kernel launch failed: CUDA error {err}")
    reml_kernel.launches += 1
    if need == "wald":
        return outs
    if not outs:
        return None
    return tuple(outs[0]) if need == "newton" else outs[0]


reml_kernel.launches = 0


def flops_and_bytes(t: int, lanes: int, need: str, step: bool = False,
                    comp: bool = False, grid: int = 0, itemsize: int = 4):
    """Work of one launch over ``lanes`` lanes of Grams of size ``t``:
    (floating-point operations, bytes), a multiply-add counted as two.

    Per lane, q = t - 1: the complement's correction 2 t^2 per Gram; the
    Cholesky q^3 / 3; a triangular solve pair 2 q^2 per right-hand side;
    for d1 the q + 1 solves of M u_1 and M G_2 and the G_2 M u_1 product,
    for Newton q + 1 more solves and the products of G_3 and (M G_2)^2;
    for the Wald step two solves at c = q - 1; about 40 for the formulas
    and the step.  Bytes: each input read once (a grid's shared block once
    per lambda, ``grid`` of them) and each output written once, floats of
    ``itemsize`` bytes, masks a byte."""
    q, s = t - 1, t - 1
    K = KMAX[need]
    m = s * (s + 1) // 2
    per = q ** 3 / 3 + 2 * q * q + 2 * q + 40  # Cholesky, M u_1, y'P y
    if comp:
        per += 2 * t * t * K
    if need in ("d1", "newton"):
        per += 2 * q ** 3 + 4 * q * q + 4 * q  # M G_2, G_2 M u_1
    if need == "newton":
        per += 2 * q ** 3 + 8 * q * q + 6 * q  # M G_3, M w, G_3 M u_1
    if need == "wald":
        per += 4 * (q - 1) ** 2 + 4 * q
    mask = 1.0 / itemsize  # a byte, in floats
    sums = {"d1": 1, "newton": 2, "lik": 1, "wald": 0}[need]
    per_lane_in = K * (s + 1) + sums + 1 + (K * m if not grid else 0)
    shared_in = grid * (K * m + sums + 1) if grid else 0
    if comp:
        per_lane_in += s + 1
        shared_in += s * s + 1
    if step:
        state_in, state_out = ((3, 3) if need == "d1"
                               else (2 + mask, 1 + mask))
    else:
        state_in, state_out = (mask if need == "lik" else 0), 0
    out = {"d1": 1, "newton": 2, "lik": 1, "wald": 5 + mask}[need]
    nbytes = itemsize * (lanes * (per_lane_in + state_in
                                  + (0 if step else out) + state_out)
                         + shared_in)
    return float(per) * lanes, float(nbytes)
