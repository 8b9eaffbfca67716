"""Kernel K1 (pygemma_tpu_torch/ops/gram_kernel.py) and its plain version.

On the CPU the wrapper runs the plain PyTorch version; it is held here to
the JAX package's Pallas kernel (interpret mode, as tests/test_pallas_kernel.py
runs it).  The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py); its launch geometry and row layout are held
here by a NumPy emulation of the kernel's partial-sum / reduce scheme, and
its 3xTF32 arithmetic by a NumPy emulation of the tensor-core products.
"""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pygemma_tpu.core.grams import grams_per_snp_lambda_fused as jax_fused
from pygemma_tpu.core.grams import pair_products as jax_pairs
from pygemma_tpu_torch.core.grams import pair_products
from pygemma_tpu_torch.ops import gram_kernel as gk

torch.set_num_threads(2)


def _kernel_constants():
    """The launch layout csrc/gram_kernel.cu defines, read from its source
    (nvcc is not needed to know it): gram_kernel.bind's ``geometry`` and
    the resident blocks per SM its launch bounds ask for, which the card's
    occupancy query gives for the kernel's ~80 KB of shared memory."""
    src = gk.SOURCE.read_text()
    val = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
           for k in ("COLS", "NBASE", "NSH", "TS")}
    blocks = int(re.search(r"__launch_bounds__\(THREADS, (\d+)\)",
                           src).group(1))
    return (val["COLS"], val["NBASE"], val["NSH"], val["TS"]), blocks


GEOMETRY, BLOCKS_PER_SM = _kernel_constants()
_, NBASE, NSH, TS = GEOMETRY


def _data(n, B, c, R=None, seed=None):
    rng = np.random.default_rng(n * 1000 + B if seed is None else seed)
    ev = np.abs(rng.normal(size=n)).astype(np.float32)
    W = rng.normal(size=(n, c)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    X = rng.normal(size=(n, B)).astype(np.float32)
    size = B if R is None else (B, R)
    lam = np.power(10.0, rng.uniform(-4, 4, size=size)).astype(np.float32)
    return ev, np.c_[W, y], X, lam


def _torch_fused(ev, shared, X, lam, kmax, want_logh):
    sh = torch.as_tensor(shared)
    return gk.fused_grams(torch.as_tensor(lam), torch.as_tensor(ev),
                          pair_products(sh), sh, torch.as_tensor(X), kmax,
                          want_logh)


def _as_grams(res, s):
    """fused_grams tuple -> the Gram tensors grams_per_snp_lambda_fused
    assembles (so the comparison uses test_pallas_kernel.py's form)."""
    from pygemma_tpu_torch.core.grams import _assemble_nd, unpack_sym

    S, vS, vv = res[:3]
    return [_assemble_nd(unpack_sym(S[..., k, :], s), vS[..., k, :],
                         vv[..., k]).numpy() for k in range(S.shape[-2])]


@pytest.mark.parametrize("n,B,c,R", [(300, 40, 3, None), (70, 10, 1, None),
                                     (515, 130, 6, None), (260, 24, 2, 2)])
@pytest.mark.parametrize("want_logh", [False, True])
def test_reference_matches_jax_kernel(n, B, c, R, want_logh):
    from jax.experimental.pallas import tpu as pltpu

    ev, shared, X, lam = _data(n, B, c, R)
    s = shared.shape[1]
    sj = jnp.asarray(shared)
    with pltpu.force_tpu_interpret_mode():
        gj, sums_j = jax_fused(jnp.asarray(lam), jnp.asarray(ev), sj,
                               jax_pairs(sj), jnp.asarray(X), (1, 2, 3),
                               want_logh=want_logh)
    res = _torch_fused(ev, shared, X, lam, 3, want_logh)
    # the JAX kernel's dots are split bf16x3 (~2^-16 operand rounding): the
    # tolerance is test_pallas_kernel.py's
    for got, ref in zip(_as_grams(res, s), gj):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=2e-4,
                                   atol=3e-4 * np.abs(ref).max())
    np.testing.assert_allclose(res[3].numpy(), sums_j.sum_d, rtol=1e-5)
    np.testing.assert_allclose(res[4].numpy(), sums_j.sum_d2, rtol=1e-5)
    np.testing.assert_allclose(res[5].numpy(), sums_j.sum_logh, rtol=1e-5,
                               atol=1e-5)


def test_wrapper_contract_on_cpu():
    """kmax=1 zeroes sum_d2, no logh zeroes sum_logh, float64 inputs come
    back float32, and the CPU path launches nothing."""
    ev, shared, X, lam = _data(50, 6, 2)
    before = gk.fused_grams.launches
    res = _torch_fused(ev.astype(np.float64), shared.astype(np.float64),
                       X.astype(np.float64), lam.astype(np.float64), 1, False)
    assert gk.fused_grams.launches == before
    assert all(t.dtype == torch.float32 for t in res)
    S, vS, vv, sd, sd2, lh = res
    assert S.shape == (6, 1, 6) and vS.shape == (6, 1, 3) and vv.shape == (6, 1)
    assert not sd2.any() and not lh.any() and sd.all()


def test_wrapper_refuses_other_devices():
    ev, shared, X, lam = _data(20, 4, 1)
    meta = [torch.empty(a.shape, device="meta") for a in (lam, ev, X)]
    sh = torch.empty(shared.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gk.fused_grams(meta[0], meta[1], pair_products(sh), sh, meta[2], 2)
    with pytest.raises(ValueError, match="kmax"):
        _torch_fused(ev, shared, X, lam, 4, False)


def _out_feature(z, f, m, s):
    """csrc/gram_kernel.cu::out_feature: slot f of feature block z -> row
    of the [pairs | 1 | shared | vv] output layout, or -1 for padding."""
    if f < NBASE:
        return NBASE * z + f if NBASE * z + f <= m else -1
    j = NSH * z + f - NBASE
    return m + 1 + j if j < s else -1


def _emulate_kernel(lam, ev, pairs, shared, v, kmax, want_logh, sm=132):
    """NumPy model of csrc/gram_kernel.cu: feature block z holds slots
    [pairs | 1] NBASE z .. NBASE (z + 1) - 1 (weight d^k) and shared
    NSH z .. NSH (z + 1) - 1 (weight d^k v), zero-padded; sample splits from launch_plan; partial
    rows, each written exactly once; fixed-order reduce.  Returns the
    (rows, B, R) array the wrapper's _split_rows reads."""
    n, B = v.shape
    R = lam.shape[1]
    m, s = pairs.shape[1], shared.shape[1]
    F = m + s + 2
    nsplit, span, rows = gk.launch_plan(n, B, R, m, s, kmax, sm,
                                        BLOCKS_PER_SM, GEOMETRY)
    base = np.c_[pairs, np.ones((n, 1))]
    lamc = lam.reshape(-1)  # column b * R + r
    x = v[:, np.arange(B * R) // R]
    part = np.zeros((nsplit, rows, B * R))
    writes = np.zeros((nsplit, rows), dtype=int)
    for sp in range(nsplit):
        sl = slice(sp * span, min(n, (sp + 1) * span))
        h = lamc[None, :] * ev[sl, None] + 1.0  # (ns, B*R)
        d = 1.0 / h
        for z in range(gk.feature_blocks(m, s, NBASE, NSH)):
            for k in range(kmax):
                for f in range(NBASE + NSH):
                    row = _out_feature(z, f, m, s)
                    if row < 0:
                        continue
                    if f < NBASE:
                        w, feat = d ** (k + 1), base[sl, NBASE * z + f]
                    else:
                        w = d ** (k + 1) * x[sl]
                        feat = shared[sl, NSH * z + f - NBASE]
                    part[sp, k * F + row] = (w * feat[:, None]).sum(0)
                    writes[sp, k * F + row] += 1
            if z == 0:
                for k in range(kmax):
                    part[sp, k * F + F - 1] = (d ** (k + 1) * x[sl] ** 2
                                               ).sum(0)
                    writes[sp, k * F + F - 1] += 1
                part[sp, kmax * F] = (np.log(h).sum(0) if want_logh else 0.0)
                writes[sp, kmax * F] += 1
    assert (writes == 1).all()
    return part.sum(axis=0).reshape(rows, B, R)


@pytest.mark.parametrize("n,B,c,R,kmax,want_logh", [
    (1000, 40, 3, 1, 3, True), (999, 30, 10, 2, 2, False),
    (300, 9, 1, 1, 1, True), (2100, 64, 6, 1, 3, False)])
def test_kernel_layout_matches_reference(n, B, c, R, kmax, want_logh):
    ev, shared, X, lam = _data(n, B, c, R, seed=5)
    lam2 = lam[:, None] if lam.ndim == 1 else lam
    pairs = pair_products(torch.as_tensor(shared)).numpy()
    rows = _emulate_kernel(lam2.astype(np.float64), ev.astype(np.float64),
                           pairs.astype(np.float64),
                           shared.astype(np.float64), X.astype(np.float64),
                           kmax, want_logh)
    got = gk._split_rows(torch.as_tensor(rows), pairs.shape[1],
                         shared.shape[1], kmax, want_logh)
    ref = gk.fused_grams_reference(torch.as_tensor(lam2), torch.as_tensor(ev),
                                   torch.as_tensor(pairs),
                                   torch.as_tensor(shared),
                                   torch.as_tensor(X), kmax, want_logh)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == tuple(b.shape)
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30))


def test_launch_plan_fills_the_card():
    # main-path shape: 2,048 columns = 16 blocks of 128, and c = 3 (11
    # [pairs | 1] and 4 shared features) is one feature block; the sample
    # axis is split into as many parts as still fit one wave of 2 blocks
    # per SM, whole tiles each
    def plan(n, B, R, m, s, kmax):
        return gk.launch_plan(n, B, R, m, s, kmax, 132, BLOCKS_PER_SM,
                              GEOMETRY)

    assert gk.feature_blocks(10, 4, NBASE, NSH) == 1
    nsplit, span, rows = plan(10000, 2048, 1, 10, 4, 3)
    assert rows == 3 * 16 + 1
    assert span % TS == 0 and span >= 256
    assert nsplit * span >= 10000 > (nsplit - 1) * span
    assert nsplit == 16 and 16 * nsplit <= 2 * 132 < 16 * (nsplit + 1)
    # c = 10, R = 2: 67 [pairs | 1] features take 5 feature blocks, and
    # 32 x 5 column blocks fill the card without a split, but no split may
    # be longer than _MAX_SPAN samples
    assert gk.feature_blocks(66, 11, NBASE, NSH) == 5
    assert plan(10000, 2048, 2, 66, 11, 3)[:2] == (10, 1024)
    # c = 1, R = 2: 32 x 1 column blocks, 8 splits, then the cap
    assert plan(10000, 2048, 2, 3, 2, 3)[0] == 10
    assert plan(6000, 2048, 2, 3, 2, 3)[0] == 8
    # more column blocks than one wave holds: only the cap splits; tiny
    # problems never split below _MIN_SPAN samples
    assert plan(10000, 50000, 1, 10, 4, 3)[0] == 10
    assert plan(1000, 50000, 1, 10, 4, 3)[0] == 1
    assert plan(70, 10, 1, 1, 2, 1)[0] == 1
    for n in (70, 1000, 9999, 10000, 20000):
        nsplit, span, _ = plan(n, 2048, 2, 66, 11, 3)
        assert span <= gk._MAX_SPAN and nsplit * span >= n


def test_bound_at_main_path_shape():
    # the tensor-core design: 82.9 MB of genotypes at 3.35 TB/s bound it
    # at every kmax; ~5.5 GFLOP of 3xTF32 products at 495 TFLOP/s and
    # ~0.3 GFLOP on the FP32 pipes stay below
    for kmax in (1, 2, 3):
        fp32, tf32, nbytes = gk.tensor_core_work(10000, 2048, 1, 10, 4, kmax,
                                                 kmax == 1)
        ms, by = gk.bound_ms(fp32, nbytes, tf32_flops=tf32)
        assert by == "bytes" and 0.0245 < ms < 0.025
    assert 5e9 < tf32 < 6e9 and fp32 < 0.4e9
    # the FP32-pipe yardstick: every product on the FP32 pipes
    flops, nbytes = gk.flops_and_bytes(10000, 2048, 1, 10, 4, 3, False)
    ms, by = gk.bound_ms(flops, nbytes)
    assert by == "operations"
    assert 0.025 < ms < 0.04  # ~2.1 GFLOP at 67 TFLOP/s
    ms1, by1 = gk.bound_ms(*gk.flops_and_bytes(10000, 2048, 1, 10, 4, 1,
                                               False))
    assert by1 == "bytes" and ms1 < ms


def _tf32_rna(x):
    """cvt.rna.tf32.f32: add half a TF32 ulp to the bits, clear the low 13."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x):
    """What the tensor core reads of a float32 operand: its top 19 bits."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def _to_f32_toward_zero(x):
    """float64 -> float32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tensor_core_sums(A, Bf, span, passes):
    """sum_i A[i, col] * Bf[i, f] as the kernel's wgmma sequence runs it:
    per 8-sample step, one instruction per TF32 operand pair in ``passes``
    (in that order) adds its 8 products (exact, as the tensor core forms
    them) to the float32 accumulator, rounding toward zero: the
    accumulation k1_ablation.py measured on the card, whose error grows
    with the split's length.  Step after step within a split of ``span``
    samples; the splits are then added in order in float32."""
    a_hi, b_hi = _tf32_rna(A), _tf32_rna(Bf)
    ops = {"hh": (a_hi, b_hi),
           "hl": (a_hi, _tf32_trunc(Bf - b_hi)),
           "lh": (_tf32_trunc(A - a_hi), b_hi)}
    n = A.shape[0]
    per = span // 8
    steps = -(-n // span) * per
    pad = steps * 8 - n
    P = []
    for p in passes:
        a, b = (np.pad(t.astype(np.float64), ((0, pad), (0, 0)))
                for t in ops[p])
        P.append(np.einsum("tic,tif->tcf", a.reshape(steps, 8, -1),
                           b.reshape(steps, 8, -1))
                 .reshape((steps // per, per) + (A.shape[1], Bf.shape[1])))
    acc = np.zeros(P[0].shape[:1] + P[0].shape[2:], np.float32)  # per split
    for t in range(per):
        for Pp in P:
            acc = _to_f32_toward_zero(acc.astype(np.float64) + Pp[:, t])
    total = np.zeros(acc.shape[1:], np.float32)
    for part in acc:
        total += part
    return total


def test_3xtf32_meets_the_parity_rule_and_1xtf32_does_not():
    """chip_smoke.py's parity rule (error <= the plain float32 error +
    1e-4 |ref| + 1e-4 max|ref|, against float64) at n = 10,000 with lambda
    over 1e-5..1e5 and a spectrum with large eigenvalues, in splits as
    long as the launch plan allows: the emulated 3xTF32 products meet it,
    a single TF32 pass does not."""
    rng = np.random.default_rng(11)
    n, cols, c = 10_000, 48, 3
    ev = np.concatenate([rng.gamma(0.5, 1.0, n - 50),
                         10.0 ** rng.uniform(2, 4, 50)]).astype(np.float32)
    shared = rng.normal(size=(n, c + 1)).astype(np.float32)
    X = rng.normal(size=(n, cols)).astype(np.float32)
    lam = np.logspace(-5, 5, cols).astype(np.float32)
    pairs = pair_products(torch.as_tensor(shared)).numpy()
    m, s = pairs.shape[1], shared.shape[1]
    base = np.c_[pairs, np.ones((n, 1), np.float32)]
    span = gk._MAX_SPAN

    # the kernel's float32 weights: h and 1/h rounded as the kernel does
    d32 = np.float32(1.0) / (lam[None, :] * ev[:, None] + np.float32(1.0))
    d64 = 1.0 / (lam[None, :].astype(np.float64) * ev[:, None] + 1.0)
    ok3, bad1 = True, False
    dk32, dk64 = d32, d64
    for k in range(3):
        if k:
            dk32, dk64 = dk32 * d32, dk64 * d64
        for A32, A64, Bf in ((dk32, dk64, base),
                             (dk32 * X, dk64 * X, shared)):
            ref = A64.T @ Bf.astype(np.float64)  # (cols, features)
            plain = (A32.T @ Bf).astype(np.float64)  # float32 GEMM
            allow = (np.abs(plain - ref) + 1e-4 * np.abs(ref)
                     + 1e-4 * np.abs(ref).max())
            # the kernel's order: a_lo b_hi, a_hi b_lo, a_hi b_hi
            e3 = np.abs(_tensor_core_sums(A32, Bf, span, ("lh", "hl", "hh"))
                        - ref)
            e1 = np.abs(_tensor_core_sums(A32, Bf, span, ("hh",)) - ref)
            ok3 &= bool((e3 <= allow).all())
            bad1 |= bool((e1 > allow).any())
    assert ok3
    assert bad1


class _FakeCuda:
    """Stands for a CUDA tensor of a given shape on cuda:<index>: what
    ``launch`` reads of its inputs and allocates for its outputs."""

    def __init__(self, shape, index):
        self.shape = tuple(shape)
        self.device = torch.device("cuda", index)

    def data_ptr(self):
        return 4096


@pytest.mark.parametrize("tensor_index,current", [(1, 0), (0, 1), (2, 0)])
def test_launch_runs_under_its_tensors_device(monkeypatch, tensor_index,
                                              current):
    """A rank whose tensors lie on cuda:1 while cuda:0 is the thread's
    current device: the occupancy query, the stream and the library call
    all run with the tensors' card current, and the current device is
    restored after."""
    state = {"current": current}
    seen = {}

    class Guard:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            self.prev, state["current"] = state["current"], self.index

        def __exit__(self, *exc):
            state["current"] = self.prev

    class Stream:
        cuda_stream = 7

    def fake_stream(dev=None):
        seen["stream"] = (dev, state["current"])
        return Stream()

    def fake_blocks(lib, kmax):
        seen["occupancy"] = state["current"]
        return 2

    class Lib:
        geometry = (128, 8, 8, 32)

        @staticmethod
        def gram_fused_launch(*args):
            seen["launch"] = state["current"]
            seen["stream_arg"] = args[-1]
            return 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", fake_stream)
    monkeypatch.setattr(gk, "_sm_count", lambda index: 132)
    monkeypatch.setattr(gk, "_blocks_per_sm", fake_blocks)
    monkeypatch.setattr(gk.torch, "empty",
                        lambda shape, **kw: _FakeCuda(shape, kw["device"].index))
    n, B, c = 1000, 64, 3
    m = (c + 1) * (c + 2) // 2
    args = [_FakeCuda(s, tensor_index)
            for s in ((B, 1), (n,), (n, m), (n, c + 1), (n, B))]
    before = gk.fused_grams.launches
    gk.launch(Lib, *args, 3, False)
    assert gk.fused_grams.launches == before + 1
    assert seen["launch"] == seen["occupancy"] == tensor_index
    assert seen["stream"] == (torch.device("cuda", tensor_index),
                              tensor_index)
    assert seen["stream_arg"] == 7
    assert state["current"] == current
