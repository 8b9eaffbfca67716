"""The port's streamed genotype formats against the JAX package's.

The same seeded codes go through ``pygemma_tpu.io`` and
``pygemma_tpu_torch.io``: packing, host slices, the on-device dequant (here
on CPU tensors) and the streamer's blocks must be bit-identical; the
driver's tables on packed/int8 input agree with the JAX package's to its
float32 contract and with the port's own float32 scan exactly.  Two defects
of the reference's block cache are held against hand-built cases instead.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import pygemma_tpu as pj
import pygemma_tpu_torch as pt
from pygemma_tpu.io import packed as jpacked
from pygemma_tpu.io import plink as jplink
from pygemma_tpu.io import quantized as jquant
from pygemma_tpu.io.streaming import SnpBlockStreamer as JStreamer
from pygemma_tpu_torch import api as tapi
from pygemma_tpu_torch import convert
from pygemma_tpu_torch.io import packed as tpacked
from pygemma_tpu_torch.io import plink as tplink
from pygemma_tpu_torch.io import quantized as tquant
from pygemma_tpu_torch.io import streaming
from pygemma_tpu_torch.io.streaming import SnpBlockStreamer as TStreamer
from test_torch_api import _compare

torch.set_num_threads(2)


def _codes(rng, n, p, coding):
    """(n, p) uint8 codes with a few missing entries in the coding's code."""
    codes = rng.integers(0, 3, size=(n, p)).astype(np.uint8)
    if coding == "bed":  # bed codes 0, 2, 3 are dosages, 1 is missing
        codes = np.array([0, 2, 3], np.uint8)[codes]
    miss = 1 if coding == "bed" else jpacked.MISSING_2BIT
    codes[1, 3] = codes[7, 3] = codes[n - 1, p - 1] = miss
    return codes


def _int8(rng, n, p):
    g = rng.integers(0, 3, size=(n, p)).astype(np.int8)
    g[1, 3] = g[7, 3] = jquant.MISSING_CODE
    return g


def test_pack_unpack_codes_match_jax(rng):
    codes = _codes(rng, 37, 21, "dosage")  # n not a multiple of 4
    packed = tpacked.pack_codes(codes)
    np.testing.assert_array_equal(packed, jpacked.pack_codes(codes))
    np.testing.assert_array_equal(tpacked.unpack_codes(packed, 37), codes)
    np.testing.assert_array_equal(tpacked.unpack_codes(packed, 37),
                                  jpacked.unpack_codes(packed, 37))


@pytest.mark.parametrize("coding", ["dosage", "bed"])
def test_packed_host_slices_match_jax(rng, coding):
    codes = _codes(rng, 37, 21, coding)
    J = jpacked.PackedMatrix.from_codes(codes, coding=coding)
    T = tpacked.PackedMatrix.from_codes(codes, coding=coding)
    assert T.shape == J.shape and T.dtype == np.float32
    np.testing.assert_array_equal(T.mu, J.mu)
    np.testing.assert_array_equal(T.sd, J.sd)
    for idx in (np.s_[:, :], np.s_[:, 3:9], np.s_[5:11, 3:9]):
        np.testing.assert_array_equal(T[idx], J[idx])
    assert T[:, 3][1] == 0.0  # missing -> standardized 0
    for start, stop in ((0, 21), (4, 13)):
        for a, b in zip(T.quant_block(start, stop),
                        J.quant_block(start, stop)):
            np.testing.assert_array_equal(a, b)


def test_quantized_host_slices_match_jax(rng):
    g = _int8(rng, 32, 21)
    J = jquant.QuantizedMatrix.from_dosages(g)
    T = tquant.QuantizedMatrix.from_dosages(g)
    np.testing.assert_array_equal(T.mu, J.mu)
    np.testing.assert_array_equal(T.sd, J.sd)
    for idx in (np.s_[:, :], np.s_[:, 3:9], np.s_[5:11, 3:9]):
        np.testing.assert_array_equal(T[idx], J[idx])
    assert float(T[1, 3]) == 0.0 == float(J[1, 3])
    assert float(T[0, 0]) == float(J[0, 0])
    with pytest.raises(ValueError, match="mode"):
        tquant.QuantizedMatrix.from_dosages(g, mode="standardise")
    big = g.astype(np.int32)
    big[0, 0] = -999
    with pytest.raises(ValueError, match="int8 range"):
        tquant.QuantizedMatrix.from_dosages(big)


@pytest.mark.parametrize("kind", ["dosage", "bed", "int8"])
def test_dequant_is_bit_identical_to_jax(rng, kind):
    """1,001 samples x 257 SNPs, missing codes included: the port's torch
    dequant on CPU tensors equals the JAX package's jitted one bit for
    bit."""
    import jax.numpy as jnp

    n, B = 1001, 257
    mu = rng.uniform(0.2, 1.8, size=B).astype(np.float32)
    sd = rng.uniform(0.3, 1.2, size=B).astype(np.float32)
    if kind == "int8":
        g = _int8(rng, n, B)
        ref = jquant.dequantize_device(jnp.asarray(g), jnp.asarray(mu),
                                       jnp.asarray(sd))
        got = tquant.dequantize_device(torch.from_numpy(g),
                                       torch.from_numpy(mu),
                                       torch.from_numpy(sd))
    else:
        packed = tpacked.pack_codes(_codes(rng, n, B, kind))
        ref = jpacked.dequantize_packed_device(
            jnp.asarray(packed), jnp.asarray(mu), jnp.asarray(sd), n=n,
            coding=kind)
        got = tpacked.dequantize_packed_device(
            torch.from_numpy(packed), torch.from_numpy(mu),
            torch.from_numpy(sd), n=n, coding=kind)
    assert got.dtype == torch.float32 and got.shape == (n, B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _matrices(rng, kind, n=37, p=21):
    if kind == "int8":
        g = _int8(rng, n, p)
        return (tquant.QuantizedMatrix.from_dosages(g),
                jquant.QuantizedMatrix.from_dosages(g))
    codes = _codes(rng, n, p, kind)
    return (tpacked.PackedMatrix.from_codes(codes, coding=kind),
            jpacked.PackedMatrix.from_codes(codes, coding=kind))


@pytest.mark.parametrize("kind", ["dosage", "bed", "int8"])
def test_streamer_blocks_match_jax(rng, kind):
    T, J = _matrices(rng, kind)
    got = list(TStreamer(T, 8, device="cpu"))
    ref = list(JStreamer(J, 8))
    assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in ref] \
        == [(0, 8), (8, 16), (16, 21)]
    for (_, _, xb), (_, _, xj) in zip(got, ref):
        assert xb.dtype == torch.float32 and xb.shape == (T.shape[0], 8)
        np.testing.assert_array_equal(xb.numpy(), np.asarray(xj))
    # and both equal the host slice; padding columns are zero codes (a bed
    # code 0 decodes to dosage 2), dropped with the block's tail
    host = np.concatenate([xb.numpy() for _, _, xb in got], axis=1)
    np.testing.assert_array_equal(host[:, :21], T[:, :])
    np.testing.assert_array_equal(host[:, 21:], 2.0 if kind == "bed" else 0.0)


def test_file_formats_round_trip_between_packages(rng, tmp_path):
    """.bed, .2b and .i8 files written by either package open in the
    other, and read back exactly."""
    n, p = 29, 11
    X = rng.integers(0, 3, size=(n, p)).astype(np.float32)
    X[2, 1] = X[9, 1] = np.nan
    tplink.write_bed(str(tmp_path / "t"), X)
    jplink.write_bed(str(tmp_path / "j"), X)
    for ext in (".bed", ".bim", ".fam"):
        assert ((tmp_path / f"t{ext}").read_bytes()
                == (tmp_path / f"j{ext}").read_bytes())
    Tb = tpacked.PackedMatrix.open_bed(str(tmp_path / "t"))
    Jb = jpacked.PackedMatrix.open_bed(str(tmp_path / "t"))
    assert Tb.coding == "bed" and Tb.shape == (n, p)
    np.testing.assert_array_equal(Tb[:, :], Jb[:, :])
    # the host reader's mean-impute + standardize (to rounding)
    d = jplink.read_bed(str(tmp_path / "t"), use_native=False)
    Xi = pj.preprocess.standardize(pj.preprocess.mean_impute(d.X))
    np.testing.assert_allclose(Tb[:, :], Xi, atol=2e-5)

    codes = _codes(rng, 37, 21, "dosage")
    Q = tpacked.PackedMatrix.from_codes(codes)
    tpacked.write_rawbin_2bit(str(tmp_path / "p2"), codes, Q.mu, Q.sd)
    jpacked.write_rawbin_2bit(str(tmp_path / "j2"), codes, Q.mu, Q.sd)
    assert ((tmp_path / "p2.2b").read_bytes()
            == (tmp_path / "j2.2b").read_bytes())
    for prefix in ("p2", "j2"):
        T2 = tpacked.PackedMatrix.open_rawbin(str(tmp_path / prefix))
        np.testing.assert_array_equal(T2[:, :], Q[:, :])
    J2 = jpacked.PackedMatrix.open_rawbin(str(tmp_path / "p2"))
    np.testing.assert_array_equal(J2[:, :], Q[:, :])
    # an already packed (p, n4) body with n given
    tpacked.write_rawbin_2bit(str(tmp_path / "pp"),
                              tpacked.pack_codes(codes).T, Q.mu, Q.sd, n=37)
    np.testing.assert_array_equal(
        tpacked.PackedMatrix.open_rawbin(str(tmp_path / "pp"))[:, :], Q[:, :])

    g = _int8(rng, 32, 21)
    T8 = tquant.QuantizedMatrix.from_dosages(g)
    tquant.write_rawbin_i8(str(tmp_path / "q"), T8.data.T, T8.mu, T8.sd)
    np.testing.assert_array_equal(
        tquant.QuantizedMatrix.open_rawbin(str(tmp_path / "q"))[:, :],
        T8[:, :])
    np.testing.assert_array_equal(
        jquant.QuantizedMatrix.open_rawbin(str(tmp_path / "q"))[:, :],
        T8[:, :])


@pytest.fixture(scope="module")
def scan_case():
    rng = np.random.default_rng(11)
    n, p = 96, 40
    codes = _codes(rng, n, p, "dosage")
    Q = tpacked.PackedMatrix.from_codes(codes)
    Xs = Q[:, :]
    K = (Xs @ Xs.T / p + 1e-3 * np.eye(n)).astype(np.float32)
    y = (Xs[:, 0] * 0.4 + rng.normal(size=n)).astype(np.float32)
    return codes, Q, K, y


def test_packed_scan_equals_float32_scan(scan_case):
    """2-bit codes + affine are an exact encoding: the port's packed scan
    and its scan of the dequantized float32 matrix give the same table."""
    codes, Q, K, y = scan_case
    cfg = pt.GwasConfig(snp_block=16, tests=("wald", "lrt", "score"))
    got = pt.pygemma(y, Q, None, K, config=cfg, device="cpu")
    ref = pt.pygemma(y, Q[:, :], None, K, config=cfg, device="cpu")
    np.testing.assert_array_equal(got.to_numpy(), ref.to_numpy())
    g8 = np.where(codes == 3, jquant.MISSING_CODE, codes).astype(np.int8)
    Q8 = tquant.QuantizedMatrix.from_dosages(g8)
    got8 = pt.pygemma(y, Q8, None, K, config=cfg, device="cpu")
    ref8 = pt.pygemma(y, Q8[:, :], None, K, config=cfg, device="cpu")
    np.testing.assert_array_equal(got8.to_numpy(), ref8.to_numpy())


@pytest.mark.parametrize("kind", ["dosage", "int8"])
def test_streamed_table_matches_jax(scan_case, kind):
    codes, Q, K, y = scan_case
    if kind == "int8":
        g8 = np.where(codes == 3, jquant.MISSING_CODE, codes).astype(np.int8)
        T, J = (tquant.QuantizedMatrix.from_dosages(g8),
                jquant.QuantizedMatrix.from_dosages(g8))
    else:
        T, J = Q, jpacked.PackedMatrix.from_codes(codes)
    ref = pj.pygemma(y, J, None, K, config=pj.GwasConfig(snp_block=16))
    got = pt.pygemma(y, T, None, K, config=pt.GwasConfig(snp_block=16),
                     device="cpu")
    _compare(got, ref, "float32")


def test_streamed_input_checks(scan_case):
    codes, Q, K, y = scan_case
    with pytest.raises(ValueError, match="float32-only"):
        pt.pygemma(y, Q, None, K, config=pt.GwasConfig(dtype="float64"),
                   device="cpu")
    bad = tpacked.PackedMatrix.from_codes(codes)
    bad.sd[2] = 0.0  # corrupt sidecar
    with pytest.raises(ValueError, match="sidecar"):
        pt.pygemma(y, bad, None, K, disable_checks=False, device="cpu")
    g8 = np.where(codes == 3, jquant.MISSING_CODE, codes).astype(np.int8)
    bad8 = tquant.QuantizedMatrix.from_dosages(g8)
    bad8.mu[0] = np.nan
    with pytest.raises(ValueError, match="sidecar"):
        pt.pygemma(y, bad8, None, K, disable_checks=False, device="cpu")


@pytest.fixture
def cache_env(monkeypatch):
    monkeypatch.setenv("PYGEMMA_TPU_GENO_DEV_CACHE_MB", "64")
    streaming.clear_device_block_cache()
    yield monkeypatch
    streaming.clear_device_block_cache()


def _rawbin(rng, tmp_path, n=24, p=40, name="pc"):
    codes = _codes(rng, n, p, "dosage")
    Q0 = tpacked.PackedMatrix.from_codes(codes)
    prefix = str(tmp_path / name)
    tpacked.write_rawbin_2bit(prefix, codes, Q0.mu, Q0.sd)
    return prefix, tpacked.PackedMatrix.open_rawbin(prefix)


def _stream(X, B):
    return np.concatenate([xb.numpy() for _, _, xb in
                           TStreamer(X, B, device="cpu")],
                          axis=1)[:, :X.shape[1]]


def test_device_block_cache_and_prefill(rng, tmp_path, cache_env):
    """Prefill ships every block once without dequantizing; the streamer
    then serves identical blocks from the cache; a cols() view gets its own
    keys; a zero budget turns the cache off."""
    prefix, Q = _rawbin(rng, tmp_path)
    p, B = Q.shape[1], 16
    assert Q.cache_token and prefix in Q.cache_token
    cache_env.setenv("PYGEMMA_TPU_GENO_DEV_CACHE_MB", "0")
    ref = _stream(Q, B)
    cache_env.setenv("PYGEMMA_TPU_GENO_DEV_CACHE_MB", "64")
    n_put = streaming.prefill_device_cache(Q, B, device="cpu")
    assert n_put == (p + B - 1) // B == len(streaming._DEV_BLOCK_CACHE)
    assert streaming.prefill_device_cache(Q, B, device="cpu") == 0
    np.testing.assert_array_equal(_stream(Q, B), ref)
    sub = Q.cols(16, 40)
    assert sub.cache_token != Q.cache_token
    assert streaming.prefill_device_cache(sub, B, device="cpu") == 2
    np.testing.assert_array_equal(_stream(sub, B), ref[:, 16:])
    # the budget bounds insertion: room for two blocks
    streaming.clear_device_block_cache()
    one = TStreamer(Q, B, device="cpu").block_bytes
    cache_env.setenv("PYGEMMA_TPU_GENO_DEV_CACHE_MB", str(2.5 * one / 2**20))
    assert streaming.prefill_device_cache(Q, B, device="cpu") == 2
    cache_env.setenv("PYGEMMA_TPU_GENO_DEV_CACHE_MB", "0")
    streaming.clear_device_block_cache()
    assert streaming.prefill_device_cache(Q, B, device="cpu") == 0
    assert len(streaming._DEV_BLOCK_CACHE) == 0


def test_cache_token_follows_the_affine(rng, tmp_path, cache_env):
    """Two open_bed matrices over one file with different mu/sd never share
    a cache entry: each streams its own standardization (the reference's
    token ignores caller-supplied mu/sd)."""
    n, p = 29, 20
    X = rng.integers(0, 3, size=(n, p)).astype(np.float32)
    prefix = str(tmp_path / "b")
    tplink.write_bed(prefix, X)
    A = tpacked.PackedMatrix.open_bed(prefix)
    mu, sd = np.zeros(p, np.float32), np.full(p, 2.0, np.float32)
    Bm = tpacked.PackedMatrix.open_bed(prefix, mu=mu, sd=sd)
    assert A.cache_token != Bm.cache_token
    assert tpacked.PackedMatrix.open_bed(prefix).cache_token == A.cache_token
    np.testing.assert_array_equal(_stream(A, 8), A[:, :])  # fills the cache
    np.testing.assert_array_equal(_stream(Bm, 8), Bm[:, :])
    np.testing.assert_array_equal(Bm[:, :], X / 2.0)
    assert len(streaming._DEV_BLOCK_CACHE) == 6  # 3 blocks each
    # a later change of the affine changes the token too
    Bm.sd[:] = 4.0
    np.testing.assert_array_equal(_stream(Bm, 8), X / 4.0)


def test_prefill_race_keeps_the_byte_count(rng, tmp_path, cache_env):
    """Prefill threads racing the streamer over one cohort: each block lands
    once and the byte count equals the sum of the cached entries (the
    reference's unlocked check-then-insert counts a block twice).  Reading
    the budget yields the thread, as a slow environment read would: the
    reference reads it between its check and its insert."""
    prefix, Q = _rawbin(rng, tmp_path, n=64, p=400)
    B = 8
    ref = _stream(Q, B)
    budget = streaming._cache_budget_bytes()

    def slow_budget():
        time.sleep(2e-4)
        return budget

    cache_env.setattr(streaming, "_cache_budget_bytes", slow_budget)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            streaming.clear_device_block_cache()
            threads = [threading.Thread(
                target=streaming.prefill_device_cache, args=(Q, B),
                kwargs={"device": "cpu"}) for _ in range(8)]
            for t in threads:
                t.start()
            got = _stream(Q, B)
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
            cache = streaming._DEV_BLOCK_CACHE
            assert len(cache) == 50
            assert cache.nbytes == cache.entry_bytes() \
                == 50 * TStreamer(Q, B, device="cpu").block_bytes
            np.testing.assert_array_equal(got, ref)
    finally:
        sys.setswitchinterval(old)


def test_prefill_overlap_in_the_driver(rng, tmp_path, cache_env):
    """PYGEMMA_TPU_PREFETCH_OVERLAP=1 fills the cache from a background
    thread during the eigendecomposition; the table is unchanged; an error
    in that thread reaches the caller."""
    prefix, Q = _rawbin(rng, tmp_path, n=48, p=40)
    Xs = Q[:, :]
    K = (Xs @ Xs.T / 40 + 1e-3 * np.eye(48)).astype(np.float32)
    y = rng.normal(size=48).astype(np.float32)
    cfg = pt.GwasConfig(snp_block=16)
    ref = pt.pygemma(y, Xs, None, K, config=cfg, device="cpu")
    streaming.clear_device_block_cache()
    cache_env.setenv("PYGEMMA_TPU_PREFETCH_OVERLAP", "1")
    got = pt.pygemma(y, Q, None, K, config=cfg, device="cpu")
    np.testing.assert_array_equal(got.to_numpy(), ref.to_numpy())
    assert len(streaming._DEV_BLOCK_CACHE) == 3

    def broken(*a, **k):
        raise OSError("prefill failed")

    streaming.clear_device_block_cache()
    cache_env.setattr(tapi, "prefill_device_cache", broken)
    with pytest.raises(OSError, match="prefill failed"):
        pt.pygemma(y, Q, None, K, config=cfg, device="cpu")


@pytest.mark.parametrize("kind", ["dosage", "bed", "int8"])
def test_convert_streamed_matrices_from_jax(rng, tmp_path, kind):
    T, J = _matrices(rng, kind)
    if kind == "bed":  # a file-backed matrix keeps its file identity
        X = rng.integers(0, 3, size=(37, 21)).astype(np.float32)
        jplink.write_bed(str(tmp_path / "c"), X)
        J = jpacked.PackedMatrix.open_bed(str(tmp_path / "c"))
        T = tpacked.PackedMatrix.open_bed(str(tmp_path / "c"))
    got = convert.from_jax(J)
    assert type(got) is type(T)
    assert got.data is J.data  # the codes are shared, not copied
    np.testing.assert_array_equal(got[:, :], T[:, :])
    for (_, _, a), (_, _, b) in zip(TStreamer(got, 8, device="cpu"),
                                    TStreamer(T, 8, device="cpu")):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if kind == "bed":
        assert got.cache_token is not None
        assert got.cache_token.startswith(J.cache_token)
    with pytest.raises(TypeError, match="no port counterpart"):
        convert.from_jax(pj.GwasConfig())


def test_read_filtered_matrix_is_bit_equal_to_jax(rng, tmp_path):
    """tests/test_io_preprocess.py's case, and a 400 x 400 file whose lines
    cross the reader's 1 MiB chunks: the port's native reader returns the
    JAX package's matrix bit for bit."""
    from pygemma_tpu.native import bed_native as jnative
    from pygemma_tpu_torch.native import bed_native

    assert bed_native.available()
    for n, idx, fmt in ((30, [29, 2, 11, 7], "%.6f"),
                        (400, [0, 5, 131, 262, 263, 399], "%.9g")):
        M = rng.normal(size=(n, n)).astype(np.float32)
        path = str(tmp_path / f"mat{n}.txt")
        np.savetxt(path, M, fmt=fmt)
        got = bed_native.read_filtered_matrix(path, idx)
        np.testing.assert_array_equal(
            got, jnative.read_filtered_matrix(path, np.asarray(idx)))
        srt = np.sort(idx)
        np.testing.assert_allclose(got, M[np.ix_(srt, srt)], rtol=1e-5,
                                   atol=1e-6)


def test_read_filtered_matrix_refuses_bad_input(tmp_path):
    from pygemma_tpu_torch.native import bed_native

    path = str(tmp_path / "m.txt")
    np.savetxt(path, np.ones((4, 6)), fmt="%.3f")
    with pytest.raises(OSError, match="rc=1"):
        bed_native.read_filtered_matrix(str(tmp_path / "none.txt"), [0])
    with pytest.raises(OSError, match="rc=4"):  # past the last row
        bed_native.read_filtered_matrix(path, [1, 5])
    with open(path, "a") as f:
        f.write("1 2\n")
    with pytest.raises(OSError, match="rc=5"):  # a row short of column 4
        bed_native.read_filtered_matrix(path, [3, 4])
    with pytest.raises(ValueError, match="distinct"):
        bed_native.read_filtered_matrix(path, [2, 2])
