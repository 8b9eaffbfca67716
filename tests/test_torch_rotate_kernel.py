"""The rotation kernel's wrapper (pygemma_tpu_torch/ops/rotate_kernel.py)
without a card: its plain version, the dispatch rule by shape, the wrapper's
refusals and the source's note.  The CUDA kernel itself runs only on the
card (tests/test_torch_cuda.py)."""

import re

import pytest
import torch

from pygemma_tpu_torch.core import eigen
from pygemma_tpu_torch.ops import rotate_kernel as rk

torch.set_num_threads(2)


def _u(n, r, column_major=False, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    if column_major:
        return torch.randn(r, n, generator=g, dtype=dtype).T
    return torch.randn(n, r, generator=g, dtype=dtype)


@pytest.mark.parametrize("r,n,B", [(7, 33, 5), (129, 130, 131), (16, 4, 257)])
@pytest.mark.parametrize("column_major", [False, True])
def test_plain_version_is_the_float64_product(r, n, B, column_major):
    """The plain version, and rotate on CPU tensors, against torch.matmul in
    float64 at ragged shapes, in both layouts of U; nothing is launched."""
    U = _u(n, r, column_major)
    X = torch.randn(n, B, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    ref = torch.matmul(U.T, X)
    before = rk.rotate_kernel.launches
    for got in (rk.rotate_plain(U, X), rk.rotate(U, X), eigen.rotate(U, X)):
        assert got.shape == (r, B) and got.dtype == torch.float64
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)
    assert rk.rotate_kernel.launches == before


@pytest.mark.parametrize("r,n,B,taken", [
    (16_384, 50_000, 4_096, True),   # implicit top space, one card
    (16_384, 50_000, 1_024, True),   # ... a quarter block a rank
    (10_000, 10_000, 2_048, True),   # dense basis
    (16_384, 20_000, 8_192, True),   # chip_smoke's implicit blocks
    (10_000, 10_000, 128, True),     # one tile wide
    (16_384, 50_000, 3, False),      # W (c columns)
    (16_384, 50_000, 4, False),      # Y of four phenotypes
    (10_000, 10_000, 124, False),    # narrower than a tile
    (10_000, 10_000, 2_050, True),   # ragged sizes: cp.async, not TMA
    (9_999, 9_999, 2_048, True),
    (16_386, 50_000, 4_096, True),
    (2_938, 2_938, 1_001, True),
])
def test_dispatch_rule(monkeypatch, r, n, B, taken):
    """Which rotations take the kernel: float32 tensors off the CPU at
    least one tile wide, whatever r, n and B's remainders; the rest (W, Y)
    go to torch.matmul.  Meta tensors stand for the card's (no data, no
    card)."""
    assert rk.takes(r, n, B) is taken
    calls = []
    monkeypatch.setattr(rk, "rotate_kernel",
                        lambda U, X: calls.append((U.shape, X.shape)))
    U = torch.empty((n, r), device="meta")
    X = torch.empty((n, B), device="meta")
    out = rk.rotate(U, X)
    assert bool(calls) is taken
    if not taken:
        assert out.shape == (r, B)
    # float64 on the card stays on torch.matmul (the kernel is float32)
    calls.clear()
    assert rk.rotate(U.double(), X.double()).shape == (r, B)
    assert not calls


@pytest.mark.parametrize("r,n,B,column_major,u_tma,x_tma", [
    (16_384, 50_000, 4_096, False, True, True),   # the implicit block
    (10_000, 10_000, 2_048, True, True, True),    # the dense block
    (10_002, 10_000, 2_048, True, True, True),    # r is not U's row here
    (10_000, 10_002, 2_048, False, True, True),   # ... nor n here
    (10_000, 10_002, 2_048, True, False, True),   # n floats a row of U'
    (10_002, 10_000, 2_048, False, False, True),  # r floats a row of U
    (10_000, 10_000, 2_049, True, True, False),   # B floats a row of X
    (9_999, 9_999, 2_050, False, False, False),
])
def test_tma_reads_u_by_its_rows_and_the_block_by_its_own(
        r, n, B, column_major, u_tma, x_tma):
    """TMA reads U only where its rows (r floats row-major, n column-major)
    are a whole number of 16 bytes from a 16-byte start, and the block only
    where its rows of B floats are; each on its own."""
    assert rk.u_by_tma(r, n, column_major) is u_tma
    assert rk.u_by_tma(r, n, column_major, aligned=False) is False
    assert rk.block_by_tma(B) is x_tma
    assert rk.block_by_tma(B, aligned=False) is False


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def refuse(U, X):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(rk, "rotate_kernel", refuse)
    U = torch.randn(256, 128)
    X = torch.randn(256, 256)
    torch.testing.assert_close(rk.rotate(U, X), U.T @ X)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"),
    ("float16", "float32"),
    ("float64", "float32"),
    ("mixed", "float32"),
    ("x_strided", "row-major"),
    ("u_strided", "row-major or column-major"),
    ("narrow", "does not take"),
    ("vector", "matrix"),
])
def test_the_wrapper_refuses(case, match):
    """rotate_kernel raises, as the REML kernel's wrapper does, on what the
    kernel cannot run: CPU tensors, other float types, mixed types, a
    non-contiguous block, a U neither row- nor column-major, a shape it does
    not take."""
    n, r, B = 256, 128, 256
    U, X = torch.randn(n, r), torch.randn(n, B)
    if case == "float16":
        U, X = U.half(), X.half()
    elif case == "float64":
        U, X = U.double(), X.double()
    elif case == "mixed":
        X = X.double()
    elif case == "x_strided":
        X = torch.randn(n, 2 * B)[:, ::2]
    elif case == "u_strided":
        U = torch.randn(n, 2 * r)[:, ::2]
    elif case == "narrow":
        X = X[:, :100].contiguous()
    elif case == "vector":
        X = X[:, 0]
    before = rk.rotate_kernel.launches
    with pytest.raises(ValueError, match=match):
        rk.rotate_kernel(U, X)
    assert rk.rotate_kernel.launches == before


def test_bound_at_the_main_path_shapes():
    """Operations bound every main-path rotation: 2 r n B at 165 TFLOP/s
    (the implicit block 40.7 ms, its bytes 1.3 ms at 3.35 TB/s)."""
    for (r, n, B), want in (((16_384, 50_000, 4_096), 40.672),
                            ((16_384, 50_000, 1_024), 10.168),
                            ((10_000, 10_000, 2_048), 2.4824)):
        ms, by = rk.bound_ms(r, n, B)
        assert by == "operations" and abs(ms / want - 1) < 1e-3


def test_the_source_note_and_geometry():
    """csrc/rotate_kernel.cu says what it replaces (no TPU kernel), what
    bounds it and what its design does about the layout, the split and the
    accumulator; its tile and promotion interval are the wrapper's."""
    src = rk.SOURCE.read_text()
    head = src[:src.index("#include")]
    for words in ("replaces no TPU kernel", "What bounds it",
                  "165 TFLOP/s", "Layout.", "K-major", "Split.", "3xTF32",
                  "Accumulator.", "round-to-nearest", "promot",
                  "Ragged shapes.", "plain"):
        assert words in head, words
    val = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
           for k in ("BM", "BN", "BK", "PROMOTE")}
    assert (val["BM"], val["BN"]) == (rk.TILE_M, rk.TILE_N)
    assert val["PROMOTE"] * val["BK"] == rk.PROMOTE_SAMPLES <= 1024


def _source_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+)",
                         rk.SOURCE.read_text()).group(1))


@pytest.mark.parametrize("r,B,blocks", [
    (16_384, 4_096, 132), (16_384, 1_024, 132), (10_000, 2_048, 132),
    (10_000, 2_048, 64), (260, 388, 132), (128, 128, 1), (16_380, 1_028, 33),
    (9_999, 2_049, 132)])
def test_the_persistent_walk_covers_every_tile_once(r, B, blocks):
    """The kernel's tile walk, as csrc/rotate_kernel.cu writes it (tile_of:
    GROUP_M row tiles a group, the persistent block b taking tiles b,
    b + blocks, ...; a grid of at most one block a tile): every tile of C is
    exactly one block's."""
    group = _source_int("GROUP_M")
    tiles_m, tiles_n = -(-r // rk.TILE_M), -(-B // rk.TILE_N)
    tiles = tiles_m * tiles_n
    blocks = min(blocks, tiles)

    def tile_of(t):
        per = group * tiles_n
        first = t // per * group
        gm = min(group, tiles_m - first)
        return first + t % per % gm, t % per // gm

    seen = []
    for b in range(blocks):
        mine = (tiles - b + blocks - 1) // blocks
        for i in range(mine):
            tm, tn = tile_of(b + i * blocks)
            assert tm < tiles_m and tn < tiles_n
            seen.append((tm, tn))
    assert sorted(seen) == [(m, n) for m in range(tiles_m)
                            for n in range(tiles_n)]
