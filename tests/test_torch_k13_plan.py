"""PyTorch port: the host-side side of K1 (csrc/cost.cu) and K3
(csrc/extract.cu) on the CPU.

K1 counts one 32-bit popcount a cost byte where the census window fits 32
bits, which the callers say through ``census_bits``; K3's shared memory
holds a ring of S pixels and the row's planes, which bounds the width the
wrapper takes.  The kernels run only on the card
(tests/test_torch_k13_card.py); here the constants the wrappers share with
the sources are read from the sources, and the popcount width is held to
what every preset's callers pass and to the plain version's check.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from fsgm_tpu_torch import (SGMParams, load_preset, stereo_sgm,
                            stereo_sgm_batch, stereo_sgm_sharded)
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.kernels import _build, cost, extract

PRESETS = ["configs/kitti_stereo.json", "configs/kitti_16path.json",
           "configs/tsukuba.json", "configs/tiled_4k.json"]


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_k3_constants_mirror_the_source():
    """SMEM_BYTES, RING_BYTES and PLANES are extract.cu's; MAX_WIDTH and
    MAX_WIDTH_RIGHT follow its planes of stride at most W + 1."""
    src = (_build.SRC_DIR / "extract.cu").read_text()
    assert _const(src, "kSmemBytes") == extract.SMEM_BYTES == 227 * 1024
    assert _const(src, "kRingBytes") == extract.RING_BYTES
    assert _const(src, "kPlanes") == extract.PLANES
    assert "const int ws = w | 1;" in src
    assert "sizeof(int) * (size_t)planes * (w + 1)" in src
    free = extract.SMEM_BYTES - extract.RING_BYTES
    assert extract.MAX_WIDTH == free // (4 * extract.PLANES) - 1
    assert extract.MAX_WIDTH_RIGHT == free // 4 - 1


def _ring(src, nd, elem):
    """extract.cu's slot_pixels and ring_depth, mirrored: (ring bytes of a
    block, ring slots of a warp)."""
    slot_bytes, warps = _const(src, "kSlotBytes"), _const(src, "kWarps")
    pb = nd * elem
    pixels = max(1, slot_bytes // pb)
    depth = extract.RING_BYTES // (warps * pixels * pb)
    return warps * depth * pixels * pb, depth


def test_k3_ring_and_widths_fit_a_block():
    """For D = 32 ... 256 in int16 and int32 S the ring has at least two
    slots a warp and fits RING_BYTES; every path's width fits a block up to
    MAX_WIDTH (config 5's 3840, the strideroll probe's 1280, KITTI and its
    column windows), one more does not with the largest ring; a KITTI row
    with the right view leaves room for three blocks an SM."""
    src = (_build.SRC_DIR / "extract.cu").read_text()
    for nd in range(32, 257, 32):
        for elem in (2, 4):
            ring, depth = _ring(src, nd, elem)
            assert depth >= 2 and ring <= extract.RING_BYTES
            for w in (1242, 983, 1280, 3840, extract.MAX_WIDTH):
                assert ring + 4 * 5 * (w + 1) <= extract.SMEM_BYTES
    ring, _ = _ring(src, 256, 4)
    assert ring == extract.RING_BYTES
    assert ring + 4 * 5 * (extract.MAX_WIDTH + 2) > extract.SMEM_BYTES
    kitti, _ = _ring(src, 128, 2)
    assert 3 * (kitti + 4 * 5 * 1243 + 1024) <= 228 * 1024


def test_k1_popcount_width_mirrors_the_source():
    """census_bits up to WORD32_BITS take the kernel's 32-bit words (one
    popcount a byte), wider ones two; the label group is one 16-byte
    store."""
    src = (_build.SRC_DIR / "cost.cu").read_text()
    assert _const(src, "kWord32Bits") == cost.WORD32_BITS
    assert "const bool w32 = census_bits <= kWord32Bits;" in src
    assert _const(src, "kGroup") == 16 and "uint4" in src
    assert [cost.popcounts_per_byte(b) for b in (24, 32, 33, 48, 62)] == [
        1, 1, 2, 2, 2]
    for path in PRESETS:
        bits = load_preset(path)["sgm"].census_bits
        assert cost.popcounts_per_byte(bits) == 1
    assert cost.popcounts_per_byte(SGMParams(census_window=(9, 7))
                                   .census_bits) == 2


def test_plain_refuses_a_word_wider_than_told():
    """5x5 census fits 24 bits and not 23; 9x7 fits 62 and not 32; both
    wrappers refuse census_bits outside 1..64, and where every word fits,
    the width changes nothing."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 256, (2, 12, 30), dtype=np.uint8))
    for window, bits in (((5, 5), 24), ((9, 7), 62)):
        cl, cr = census_transform(img, window).unbind(0)
        want = cost.census_cost(cl, cr, 16)
        for rr in (False, True):
            assert torch.equal(cost.census_cost(cl, cr, 16, 255, rr, bits),
                               cost.census_cost(cl, cr, 16, 255, rr))
        narrow = 23 if bits == 24 else 32
        with pytest.raises(ValueError, match="wider than census_bits"):
            cost.census_cost_plain(cl, cr, 16, 255, False, narrow)
        with pytest.raises(ValueError, match="wider than census_bits"):
            cost.census_cost(cl, cr, 16, 255, True, narrow)
        assert torch.equal(cost.census_cost_plain(cl, cr, 16, 255, False,
                                                  bits), want)
    for bad in (0, 65):
        with pytest.raises(ValueError):
            cost.census_cost(cl, cr, 16, 255, False, bad)
        with pytest.raises(ValueError):
            cost.census_cost_plain(cl, cr, 16, 255, False, bad)


@pytest.mark.parametrize("path", PRESETS)
def test_every_preset_caller_passes_its_census_width(monkeypatch, path):
    """stereo_sgm (and, with lr_mode="reagg", its right reference),
    stereo_sgm_batch and the tiled path hand K1 the preset's own
    census_bits."""
    preset = load_preset(path)
    p = dataclasses.replace(preset["sgm"], max_disp=16)
    seen = []
    plain = cost.census_cost_plain

    def spy(*args, **kw):
        seen.append(args[5] if len(args) > 5 else kw["census_bits"])
        return plain(*args, **kw)

    monkeypatch.setattr(cost, "census_cost_plain", spy)
    rng = np.random.default_rng(5)
    il, ir = (torch.from_numpy(rng.integers(0, 256, (2, 16, 24),
                                            dtype=np.uint8))
              for _ in range(2))
    stereo_sgm(il[0], ir[0], p)
    stereo_sgm(il[0], ir[0], dataclasses.replace(p, lr_mode="reagg"))
    stereo_sgm_batch(il, ir, p)
    if "dist" in preset:
        stereo_sgm_sharded(il, ir, p, preset["dist"])
    assert len(seen) >= 4 and set(seen) == {p.census_bits}
    assert p.census_bits == 24
