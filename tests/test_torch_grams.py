"""Port Gram builders (pygemma_tpu_torch.core.grams) against the JAX ones."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pygemma_tpu.core import grams as jg
from pygemma_tpu_torch.core import grams as tg

torch.set_num_threads(2)

TOL = {  # float64: same arithmetic; float32: summation order differs
    "float64": dict(rtol=1e-12, atol_scale=1e-13),
    "float32": dict(rtol=1e-4, atol_scale=2e-5),
}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    n, B, c = 90, 7, 3
    return dict(
        ev=np.abs(rng.normal(size=n)) * 3,
        shared=rng.normal(size=(n, c + 1)),
        v=rng.normal(size=(n, B)),
        lam=np.power(10.0, rng.uniform(-3, 3, size=B)),
        lam2=np.power(10.0, rng.uniform(-3, 3, size=(B, 2))),
        grid=np.power(10.0, np.arange(-5.0, 6.0)),
    )


def _close(got, ref, dtype):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got)
    ref = np.asarray(ref)
    t = TOL[dtype]
    np.testing.assert_allclose(
        got, ref, rtol=t["rtol"],
        atol=t["atol_scale"] * max(np.abs(ref).max(), 1e-300))


def _both(inputs, dtype):
    J = {k: jnp.asarray(np.asarray(v, dtype)) for k, v in inputs.items()}
    T = {k: torch.as_tensor(np.asarray(v, dtype)) for k, v in inputs.items()}
    return J, T


def _cmp_build(jout, tout, dtype):
    (jgr, js), (tgr, ts) = jout, tout
    assert len(jgr) == len(tgr)
    for a, b in zip(tgr, jgr):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, dtype)
    for a, b in zip(ts, js):
        _close(a, b, dtype)


def _assembled(packed):
    """A packed build as (Gram tensors, sums), the JAX builders' form."""
    return tg.assemble(packed), packed.sums


def _slots(lam2, ev, shared, pairs, v, v2, ks):
    """Per-slot builds of a (B, R) lambda stacked on axis 1, as the JAX
    package's grams_per_snp_lambda_slots."""
    parts = [tg.grams_per_snp_lambda(lam2[:, r], ev, shared, pairs, v, v2,
                                     ks, want_logh=True)
             for r in range(lam2.shape[1])]
    grams = tuple(torch.stack([g[i] for g, _ in parts], dim=1)
                  for i in range(len(ks)))
    sums = tg.GramSums(*(torch.stack([sm[i] for _, sm in parts], dim=1)
                         for i in range(3)))
    return grams, sums


BUILDERS = ["pairs", "unpack", "shared", "multi", "per_snp", "slots",
            "permute", "assemble_nd"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("builder", BUILDERS)
def test_builder_matches_jax(inputs, builder, dtype):
    J, T = _both(inputs, dtype)
    jp, tp = jg.pair_products(J["shared"]), tg.pair_products(T["shared"])
    s = inputs["shared"].shape[1]
    jv2, tv2 = J["v"] * J["v"], T["v"] * T["v"]
    if builder == "pairs":
        _close(tp, jp, dtype)
    elif builder == "unpack":
        _close(tg.unpack_sym(tp, s), jg.unpack_sym(jp, s), dtype)
    elif builder == "shared":
        for ks, logh in (((1,), False), ((1, 2), True), ((1, 3), True)):
            _cmp_build(
                jg.grams_shared_lambda(J["lam"][0], J["ev"], J["shared"], jp,
                                       J["v"], jv2, ks, want_logh=logh),
                tg.grams_shared_lambda(T["lam"][0], T["ev"], T["shared"], tp,
                                       T["v"], tv2, ks, want_logh=logh),
                dtype)
    elif builder == "multi":
        for ks, logh in (((1, 2), False), ((1,), True)):
            _cmp_build(
                jg.grams_shared_multi(J["grid"], J["ev"], J["shared"], jp,
                                      J["v"], jv2, ks, want_logh=logh),
                _assembled(tg.grams_shared_multi_packed(
                    T["grid"], T["ev"], T["shared"], tp, T["v"], tv2, ks,
                    want_logh=logh)),
                dtype)
    elif builder == "per_snp":
        for ks, logh in (((1, 2, 3), True), ((2,), False)):
            _cmp_build(
                jg.grams_per_snp_lambda(J["lam"], J["ev"], J["shared"], jp,
                                        J["v"], jv2, ks, want_logh=logh),
                tg.grams_per_snp_lambda(T["lam"], T["ev"], T["shared"], tp,
                                        T["v"], tv2, ks, want_logh=logh),
                dtype)
    elif builder == "slots":
        _cmp_build(
            jg.grams_per_snp_lambda_slots(J["lam2"], J["ev"], J["shared"], jp,
                                          J["v"], jv2, (1, 2, 3),
                                          want_logh=True),
            _slots(T["lam2"], T["ev"], T["shared"], tp, T["v"], tv2,
                   (1, 2, 3)),
            dtype)
    elif builder == "permute":
        A = np.random.default_rng(3).normal(size=(4, 2, s + 1, s + 1))
        _close(tg.permute_x_before_y(torch.as_tensor(A), s - 1),
               jg.permute_x_before_y(jnp.asarray(A), s - 1), dtype)
    else:
        rng = np.random.default_rng(4)
        S = rng.normal(size=(5, 3, s, s))
        vS = rng.normal(size=(5, 3, s))
        vv = rng.normal(size=(5, 3))
        _close(tg._assemble_nd(*map(torch.as_tensor, (S, vS, vv))),
               jg._assemble_nd(*map(jnp.asarray, (S, vS, vv))), dtype)


@pytest.mark.parametrize("lam_key", ["lam", "lam2"])
def test_fused_builder_on_cpu_matches_jax_unfused(inputs, lam_key):
    """On CPU tensors the fused builder takes the kernel's plain version; it
    must agree with the JAX unfused builder (float32 contract)."""
    J, T = _both(inputs, "float32")
    jp, tp = jg.pair_products(J["shared"]), tg.pair_products(T["shared"])
    jv2 = J["v"] * J["v"]
    jfn = (jg.grams_per_snp_lambda if lam_key == "lam"
           else jg.grams_per_snp_lambda_slots)
    ks = (3, 1)  # unsorted on purpose: the result is ascending-k
    _cmp_build(
        jfn(J[lam_key], J["ev"], J["shared"], jp, J["v"], jv2, (1, 3),
            want_logh=True),
        _assembled(tg.grams_per_snp_lambda_fused_packed(
            T[lam_key], T["ev"], T["shared"], tp, T["v"], ks,
            want_logh=True)),
        "float32")


def test_complement_is_refused(inputs):
    """A complement whose per-SNP residuals do not match the block is
    refused (one row would broadcast silently); a matching one is folded
    in: with zero residuals it adds n_comp * w_c^k to the weight sums."""
    _, T = _both(inputs, "float64")
    tp = tg.pair_products(T["shared"])
    B, s = T["v"].shape[1], T["shared"].shape[1]
    args = (T["lam"], T["ev"], T["shared"], tp, T["v"], T["v"] ** 2, (1, 2))

    def comp(rows):
        z = torch.zeros((), dtype=torch.float64)
        return tg.GramComplement(z + 0.5, 7, torch.zeros(s, s, dtype=z.dtype),
                                 torch.zeros(rows, s, dtype=z.dtype),
                                 torch.zeros(rows, dtype=z.dtype))

    with pytest.raises(ValueError, match="residuals of 1 SNPs"):
        tg.grams_per_snp_lambda(*args, comp=comp(1))
    (A1, A2), sums = tg.grams_per_snp_lambda(*args, comp=comp(B))
    (B1, B2), ref = tg.grams_per_snp_lambda(*args)
    assert torch.equal(A1, B1) and torch.equal(A2, B2)
    wc = 1.0 / (T["lam"] * 0.5 + 1.0)
    torch.testing.assert_close(sums.sum_d, ref.sum_d + 7 * wc)
    torch.testing.assert_close(sums.sum_d2, ref.sum_d2 + 7 * wc * wc)
