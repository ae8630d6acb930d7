"""PyTorch port: the host-side side of K5 (csrc/transpose.cu,
label_minor_from_major) on the CPU.

The tiled kernel stages each of a tile's label rows from the aligned
16-byte chunks that cover its 128 columns, funnel-shifts words of the
staged rows by the row's shift, turns 4 x 4 byte blocks with __byte_perm
and writes the tile's output span from a staged copy whose 4-pixel quads
sit at an odd count of chunks.  The kernels run only on the card
(tests/test_torch_k5_card.py); here the constants the wrapper shares with
the source are read from the source, the staged layouts are held to their
bank rule and to the card's shared memory, a numpy model of the tiled
kernel's index arithmetic (chunks, shifts, byte permutes, staged output)
is held to numpy's transpose at ragged shapes and odd base addresses, the
bench's sector count to a brute-force count, the plain version to numpy,
and the wrapper's refusals to its contract.
"""

import re

import numpy as np
import pytest
import torch

from fsgm_tpu_torch.ops.kernels import _build, transpose
from fsgm_tpu_torch.utils import k5_bench

SRC = (_build.SRC_DIR / "transpose.cu").read_text()
BLOCK_SMEM = 232448  # an H100 block's shared memory, at most
CHUNK = transpose.LABEL_GROUP


def _const(name: str) -> str:
    return re.search(rf"constexpr int {name} = ([^;]+);", SRC).group(1)


def test_k5_constants_mirror_the_source():
    """LABEL_GROUP, TILE_W, ROW_CHUNKS and MAX_TILED_LABELS are
    transpose.cu's kChunk, kTileW, kRowChunks and kChunk x kMaxGroups;
    staged_bytes is its smem_bytes; the bench counts sectors with the
    kernel's tile width."""
    assert int(_const("kChunk")) == CHUNK == 16
    assert int(_const("kTileW")) == transpose.TILE_W == k5_bench.TILE_W
    assert _const("kRowChunks") == "kTileW / kChunk + 1"
    assert transpose.ROW_CHUNKS == transpose.TILE_W // CHUNK + 1
    assert int(_const("kMaxGroups")) * CHUNK == transpose.MAX_TILED_LABELS
    assert "return kChunk * g * kRowChunks * kChunk;" in SRC
    assert "return kTileW / 4 * quad_chunks(g) * kChunk;" in SRC
    assert "return in_bytes(g) + out_bytes(g);" in SRC
    assert transpose.staged_bytes(96) == 26624
    assert "quad_chunks(int g) { return 4 * g + 1; }" in SRC
    assert int(_const("kBlockSmem")) == BLOCK_SMEM
    for fn in ("cp_async16", "__byte_perm", "__funnelshift_r"):
        assert fn in SRC


def test_k5_staged_layouts_fit_and_spread_over_the_banks():
    """For every tiled L (16 ... 256): a block's buffers fit the card's
    shared memory; the eight lanes of a quarter-warp, on eight consecutive
    quads, store their 16-byte chunks to eight distinct bank groups; the
    copy-out's staged index c + c // 4G maps the span one to one into the
    staged output; a staged row holds the 128 columns at any shift."""
    assert transpose.ROW_CHUNKS % 2 == 1
    for s in range(CHUNK):
        assert -(-(s + transpose.TILE_W) // CHUNK) <= transpose.ROW_CHUNKS
    for g in range(1, transpose.MAX_TILED_LABELS // CHUNK + 1):
        nl = CHUNK * g
        assert transpose.tiled(nl) and not transpose.tiled(nl + 1)
        assert transpose.staged_bytes(nl) <= BLOCK_SMEM
        quad = 4 * g + 1
        for j in range(4):
            for first in range(0, 32, 8):
                lanes = np.arange(first, first + 8)
                assert len(set((lanes * quad + j * g) % 8)) == 8, (g, j)
        c = np.arange(transpose.TILE_W * g)
        staged = c + c // (4 * g)
        assert len(set(staged)) == len(c)
        assert staged.max() < transpose.TILE_W // 4 * quad
        quads, within = np.divmod(staged, quad)
        pix, grp = divmod(c, g)
        assert np.array_equal(quads * 4 + within // g, pix)
        assert np.array_equal(within % g, grp)
    assert not transpose.tiled(0) and not transpose.tiled(272)


def _prmt(a: int, b: int, sel: int) -> int:
    src = a.to_bytes(4, "little") + b.to_bytes(4, "little")
    return int.from_bytes(bytes(src[(sel >> 4 * i) & 7] for i in range(4)),
                          "little")


def _model_tiled(mem: np.ndarray, off: int, h: int, nl: int, w: int):
    """The tiled kernel's arithmetic in numpy: the (H, L, W) volume at byte
    off of mem, staged, shifted, permuted and written out tile by tile."""
    g_n, tw, rc = nl // CHUNK, transpose.TILE_W, transpose.ROW_CHUNKS
    lo, hi = off, off + h * nl * w
    out = np.zeros(h * w * nl, np.uint8)
    for y in range(h):
        for x0 in range(0, w, tw):
            n = min(tw, w - x0)
            staged = np.zeros((nl, rc * CHUNK), np.uint8)
            for l in range(nl):
                a = lo + (y * nl + l) * w + x0
                for c in range(rc):
                    if c * CHUNK >= a % 16 + n:
                        continue
                    src = a // 16 * 16 + c * CHUNK
                    for k in range(CHUNK):
                        if lo <= src + k < hi:
                            staged[l, c * CHUNK + k] = mem[src + k]
            words = staged.view("<u4").astype(np.int64)
            s0 = (lo + y * nl * w + x0) % 16
            qc = 4 * g_n + 1
            staged_out = np.zeros((tw // 4 * qc, CHUNK), np.uint8)
            for g in range(g_n):
                for lane in range(32):
                    if 4 * lane >= n:
                        continue
                    px = np.zeros((4, 4), np.int64)
                    for q in range(4):
                        v = []
                        for k in range(4):
                            r = 4 * q + k
                            s = (s0 + r * (w % 16)) % 16
                            i = (s >> 2) + lane
                            row = words[CHUNK * g + r]
                            v.append(((int(row[i + 1]) << 32 | int(row[i]))
                                      >> ((s & 3) * 8)) & 0xffffffff)
                        t0, t1 = _prmt(v[0], v[1], 0x5140), _prmt(
                            v[0], v[1], 0x7362)
                        t2, t3 = _prmt(v[2], v[3], 0x5140), _prmt(
                            v[2], v[3], 0x7362)
                        px[:, q] = (_prmt(t0, t2, 0x5410),
                                    _prmt(t0, t2, 0x7632),
                                    _prmt(t1, t3, 0x5410),
                                    _prmt(t1, t3, 0x7632))
                    for j in range(4):
                        staged_out[lane * qc + j * g_n + g] = (
                            px[j].astype("<u4").view(np.uint8))
            span = (y * w + x0) * nl
            for c in range(n * g_n):
                out[span + c * CHUNK:span + (c + 1) * CHUNK] = \
                    staged_out[c + c // (4 * g_n)]
    return out.reshape(h, w, nl)


def test_k5_model_of_the_tiled_kernel_is_a_transpose():
    """The model equals numpy's transpose: two tiles a row and a ragged
    one, W mod 16 = 6, 5, 3, 9 (every row its own shift), the volume at
    byte 0, 5, 11 and 15 of a buffer that ends with it."""
    for h, nl, w, off in ((2, 32, 150, 0), (1, 48, 37, 5), (2, 16, 131, 11),
                          (1, 32, 9, 15)):
        rng = np.random.default_rng(h * nl * w + off)
        mem = rng.integers(0, 256, off + h * nl * w, dtype=np.uint8)
        vol = mem[off:].reshape(h, nl, w)
        np.testing.assert_array_equal(_model_tiled(mem, off, h, nl, w),
                                      np.swapaxes(vol, 1, 2))


def test_k5_sector_bytes_counts_every_touched_sector():
    """k5_bench.sector_bytes against a brute-force count of the 32-byte
    sectors each tile's input rows and output span touch."""
    def brute(h, nl, w, tw):
        total = 0
        for y in range(h):
            for x0 in range(0, w, tw):
                n = min(tw, w - x0)
                spans = [((y * nl + l) * w + x0, n) for l in range(nl)]
                spans.append(((y * w + x0) * nl, n * nl))
                total += sum((a + k - 1) // 32 - a // 32 + 1
                             for a, k in spans)
        return total * 32

    for h, nl, w in ((3, 96, 155), (2, 32, 53), (1, 16, 1), (4, 48, 300)):
        assert k5_bench.sector_bytes(h, nl, w) == brute(h, nl, w, 128)
    assert k5_bench.sector_bytes(2, 32, 256, 128) == 2 * 2 * 32 * 4 * 32 * 2


@pytest.mark.parametrize("nl", [16, 32, 96, 128, 81])
def test_plain_matches_numpy_at_ragged_widths(nl):
    """label_minor_from_major_plain (and the wrapper on the CPU) == numpy's
    transpose at W = 1, 15, 17, 53, 155, 1242."""
    rng = np.random.default_rng(nl)
    for w in (1, 15, 17, 53, 155, 1242):
        vol = rng.integers(0, 256, (2, nl, w), dtype=np.uint8)
        want = np.swapaxes(vol, 1, 2)
        for fn in (transpose.label_minor_from_major_plain,
                   transpose.label_minor_from_major):
            got = fn(torch.from_numpy(vol))
            assert got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(), want)


def test_k5_refusals():
    """Another dtype or rank (3 or 4 dims: a frame axis) raises TypeError on
    any device; a device that is neither the CPU nor CUDA raises ValueError
    (no plain fallback)."""
    for bad in (torch.zeros((2, 16, 4), dtype=torch.int16),
                torch.zeros((16, 4), dtype=torch.uint8),
                torch.zeros((1, 1, 2, 16, 4), dtype=torch.uint8),
                torch.zeros((2, 16, 4), dtype=torch.int8, device="meta")):
        with pytest.raises(TypeError, match="uint8"):
            transpose.label_minor_from_major(bad)
    with pytest.raises(ValueError, match="unsupported device"):
        transpose.label_minor_from_major(
            torch.zeros((2, 16, 4), dtype=torch.uint8, device="meta"))
