"""The generator repeats from a seed, keeps every size across seeds, and
hands the program and the reference the same genotypes."""

import numpy as np
import torch

from conftest import SEED
from gwas_bench import cohorts as gen


def _cell_cohort(small_cell, name, seed):
    cell = small_cell(name)
    return gen.make_cohorts(cell.config, cell.traffic, seed, "cpu")


def test_seed_repeats_and_sizes_hold(small_cell):
    for name in ("ukb_synth_50k.pheno4", "wtccc_dense_10k.study"):
        a = _cell_cohort(small_cell, name, SEED)
        b = _cell_cohort(small_cell, name, SEED)
        c = _cell_cohort(small_cell, name, SEED + 1)
        assert len(a) == len(b) == len(c)
        for x, y, z in zip(a, b, c):
            for field in x._fields:
                u, v, w = getattr(x, field), getattr(y, field), \
                    getattr(z, field)
                if isinstance(u, np.ndarray):
                    assert np.array_equal(u, v)
                    assert u.shape == w.shape
                    assert not np.array_equal(u, w)
        if len(a) > 1:  # two cohorts of one run differ
            assert not np.array_equal(a[0].Y, a[1].Y)


def test_packed_codes_are_the_programs(small_cell):
    """The reference's decode of the 2-bit codes equals the program's host
    dequantization of the same codes (io.packed's bit order and affine)."""
    from pygemma_tpu_torch.io.packed import PackedMatrix

    co = _cell_cohort(small_cell, "ukb_synth_50k.scan", SEED)[0]
    X = PackedMatrix(co.packed.T, co.n, co.mu, co.sd)
    idx = np.array([0, 5, 511, co.p - 1])
    mine = co.columns(idx, "cpu").numpy()
    theirs = np.stack([X[:, int(i):int(i) + 1][:, 0] for i in idx], axis=1)
    np.testing.assert_allclose(mine, theirs, rtol=1e-6, atol=1e-6)
    codes = np.round(mine * co.sd[idx] + co.mu[idx])
    assert set(np.unique(codes)) <= {0.0, 1.0, 2.0}


def test_dense_kinship_is_the_grm(small_cell):
    co = _cell_cohort(small_cell, "wtccc_dense_10k.scan", SEED)[0]
    X = co.X.astype(np.float64)
    K = X @ X.T / co.p + 1e-4 * np.eye(co.n)
    np.testing.assert_allclose(co.K, K, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(X.mean(0), 0.0, atol=1e-5)


def test_derive_is_stable():
    assert gen.derive(SEED, "cohort", 0) == gen.derive(SEED, "cohort", 0)
    assert gen.derive(SEED, "cohort", 0) != gen.derive(SEED, "cohort", 1)
    assert 0 <= gen.derive(2 ** 40, "judge") < 2 ** 63
    torch.Generator().manual_seed(gen.derive(SEED, "x"))
