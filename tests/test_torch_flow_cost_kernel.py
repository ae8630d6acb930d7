"""PyTorch port: K6 flow_cost (csrc/flow_cost.cu), the flow cost volume
written label-minor in one launch.

On the CPU the wrapper takes flow_cost_plain, the label-major build and
one axis exchange; here it is held to the label-minor reference
(cost_volume_flow) with invalid_cost in the pad labels, to the label-major
build exchanged, over one and three slices, in tiled form (halo-extended
bases, y_offset > 0) to the matching rows of an untiled call, and to its
refusals.  A Python model of the kernel's index arithmetic (staged window
region, invalid mark, unit -> (pixel, group) map, incremental label walk)
is held to the plain version, with the source's constants read from the
source.  Tests marked ``cuda`` hold the kernel to the plain version bit
for bit on the card and skip without one.
"""

import re

import numpy as np
import pytest
import torch

from fsgm_tpu_torch.ops.cost import cost_volume_flow, cost_volume_flow_major
from fsgm_tpu_torch.ops.kernels import _build
from fsgm_tpu_torch.ops.kernels import flow_cost as fc
from fsgm_tpu_torch.ops.kernels.transpose import label_minor_from_major_plain

torch.set_num_threads(1)

SRC = (_build.SRC_DIR / "flow_cost.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _inputs(n, h, w, radius, bits=24, spread=3, h2=None, halo=0, seed=0,
            dev="cpu"):
    """Census words below 2^bits, a second image of h2 rows and bases of
    h + 2 halo rows in [-spread, spread]; (N, ...) tensors on dev."""
    rng = np.random.default_rng(seed)
    h2 = h if h2 is None else h2
    c1 = rng.integers(0, 1 << bits, (n, h, w), dtype=np.int64)
    c2 = rng.integers(0, 1 << bits, (n, h2, w), dtype=np.int64)
    bu, bv = (rng.integers(-spread, spread + 1, (n, h + 2 * halo, w),
                           dtype=np.int32) for _ in "uv")
    return tuple(torch.from_numpy(x).to(dev) for x in (c1, c2, bu, bv))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 3])
def test_cpu_route_matches_the_plain_builds(n):
    """flow_cost on CPU tensors: the first nl labels equal cost_volume_flow
    (label-minor, unpadded), the pad labels hold invalid_cost, and the whole
    equals the label-major build exchanged; a 2-D call is the slice
    alone."""
    r, nl, nl_pad, inv = 2, 25, 32, 201
    c1, c2, bu, bv = _inputs(n, 23, 37, r, seed=n)
    got = fc.flow_cost(c1, c2, bu, bv, r, inv, nl_pad, census_bits=24)
    assert got.shape == (n, 23, 37, nl_pad) and got.dtype == torch.uint8
    assert torch.equal(got[..., :nl], cost_volume_flow(c1, c2, bu, bv, r,
                                                       inv))
    assert bool((got[..., nl:] == inv).all())
    assert torch.equal(got, label_minor_from_major_plain(
        cost_volume_flow_major(c1, c2, bu, bv, r, inv, nl_pad)))
    assert bool((got[..., :nl] == inv).any() and (got[..., :nl] < 25).any())
    assert torch.equal(fc.flow_cost(c1[0], c2[0], bu[0], bv[0], r, inv,
                                    nl_pad), got[0])


def test_tiled_form_equals_the_untiled_rows():
    """A row tile's call (its census rows, the whole second image, the
    bases of its rows and radius halo rows each side, y_offset its first
    row) equals those rows of the untiled call, at every tile of three:
    halo rows outside the image hold arbitrary bases and count as
    outside."""
    r, h, ht = 3, 24, 8
    c1, c2, bu, bv = _inputs(2, h, 41, r, spread=4, seed=5)
    whole = fc.flow_cost(c1, c2, bu, bv, r, 255, 64)
    rng = np.random.default_rng(6)
    pad = lambda b: torch.cat([torch.from_numpy(rng.integers(  # noqa: E731
        -40, 40, (2, r, 41), dtype=np.int32)), b, torch.from_numpy(
            rng.integers(-40, 40, (2, r, 41), dtype=np.int32))], 1)
    bu_x, bv_x = pad(bu), pad(bv)
    for k in range(h // ht):
        lo, hi = k * ht, (k + 1) * ht
        got = fc.flow_cost(c1[:, lo:hi], c2, bu_x[:, lo:hi + 2 * r],
                           bv_x[:, lo:hi + 2 * r], r, 255, 64, y_offset=lo)
        assert torch.equal(got, whole[:, lo:hi]), k


def test_argument_checks_raise():
    c1, c2, bu, bv = _inputs(2, 8, 16, 1)
    ok = (c1, c2, bu, bv, 1, 255, 16)
    fc.flow_cost(*ok)
    bad = [
        ((c1.int(), c2, bu, bv, 1, 255, 16), TypeError),
        ((c1, c2, bu.long(), bv, 1, 255, 16), TypeError),
        ((c1[0], c2, bu, bv, 1, 255, 16), ValueError),
        ((c1, c2[:1], bu, bv, 1, 255, 16), ValueError),
        ((c1, c2[..., 1:], bu, bv, 1, 255, 16), ValueError),
        ((c1, c2, bu[:, 1:], bv[:, 1:], 1, 255, 16), ValueError),
        ((c1, c2, bu, bv[:, :, 1:], 1, 255, 16), ValueError),
        ((c1, c2, bu, bv, 8, 255, 256), ValueError),
        ((c1, c2, bu, bv, 1, 255, 24), ValueError),
        ((c1, c2, bu, bv, 2, 255, 16), ValueError),
        ((c1, c2, bu, bv, 1, 255, 272), ValueError),
        ((c1, c2, bu, bv, 1, 256, 16), ValueError),
        ((c1, c2, bu, bv, 1, 255, 16, 0, 0), ValueError),
        ((c1, c2, bu, bv, 1, 255, 16, 0, 20), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            fc.flow_cost(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        fc.flow_cost(*(x.to("meta") for x in ok[:4]), *ok[4:])


def _model(c1, c2, bu, bv, r, inv, nl_pad, y_off, bits):
    """csrc/flow_cost.cu's arithmetic, block by block and thread by
    thread, in numpy."""
    th, tw, group = _const("kTileH"), _const("kTileW"), _const("kGroup")
    mark = 1 << (31 if bits <= fc.WORD32_BITS else 63)
    keep = (mark << 1) - 1
    n_, h, w = c1.shape
    h2, hb = c2.shape[1], bu.shape[1]
    e = 2 * r + 1
    nl, groups, halo = e * e, nl_pad // group, (hb - h) // 2
    sw = tw + 2 * r
    out = np.zeros((n_, h, w, nl_pad), np.uint8)
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    for tile in range(n_ * tiles_y * tiles_x):
        n, rest = divmod(tile, tiles_y * tiles_x)
        y0, x0 = th * (rest // tiles_x), tw * (rest % tiles_x)
        stage = []
        for q in range((th + 2 * r) * sw):
            yy, xx = y0 - r + q // sw, x0 - r + q % sw
            brow, word = yy + halo, mark
            if 0 <= brow < hb and 0 <= xx < w:
                gy = yy + y_off
                sy, sx = gy + int(bv[n, brow, xx]), xx + int(bu[n, brow, xx])
                if 0 <= gy < h2 and 0 <= sy < h2 and 0 <= sx < w:
                    word = int(c2[n, sy, sx]) & keep
            stage.append(word)
        for u in range(th * tw * groups):
            chunk, g = divmod(u >> 4, groups)
            ty, tx = divmod(chunk * 16 + (u & 15), tw)
            if y0 + ty >= h or x0 + tx >= w:
                continue
            l0, v = g * group, [inv] * group
            if l0 < nl:
                a = int(c1[n, y0 + ty, x0 + tx]) & keep
                dv, du = divmod(l0, e)
                off = (ty + dv) * sw + tx + du
                for k in range(group):
                    if l0 + k < nl and not stage[off] & mark:
                        v[k] = bin(a ^ stage[off]).count("1")
                    off, du = off + 1, du + 1
                    if du == e:
                        du, off = 0, off + sw - e
            out[n, y0 + ty, x0 + tx, l0:l0 + group] = v
    return out


@pytest.mark.parametrize("case", ["untiled", "tiled"])
def test_kernel_model_matches_the_plain_version(case):
    """The constants mirror the source; the model of the kernel (32-bit
    words and a ragged tile untiled, 64-bit words and halo bases tiled)
    equals flow_cost_plain."""
    assert _const("kGroup") == fc.LABEL_GROUP
    assert _const("kMaxRadius") == fc.MAX_RADIUS
    assert _const("kGroup") * _const("kMaxGroups") == fc.MAX_SLOTS
    assert _const("kWord32Bits") == fc.WORD32_BITS
    assert _const("kTileW") % 16 == 0
    if case == "untiled":
        r, bits, nl_pad, halo, h2, y_off = 2, 24, 32, 0, None, 0
        c1, c2, bu, bv = _inputs(2, 19, 70, r, bits, spread=9, seed=1)
    else:
        r, bits, nl_pad, halo, h2, y_off = 3, 62, 64, 3, 30, 5
        c1, c2, bu, bv = _inputs(1, 17, 66, r, bits, spread=9, h2=h2,
                                 halo=halo, seed=2)
    want = fc.flow_cost_plain(c1, c2, bu, bv, r, 200, nl_pad, y_off, bits)
    got = _model(*(x.numpy() for x in (c1, c2, bu, bv)), r, 200, nl_pad,
                 y_off, bits)
    assert np.array_equal(got, want.numpy())


def _check_card(args, y_offset=0, bits=24):
    _build.LAUNCHES.clear()
    got = fc.flow_cost(*args, y_offset=y_offset, census_bits=bits)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flow_cost"] == 1
    want = fc.flow_cost_plain(*args, y_offset=y_offset, census_bits=bits)
    assert torch.equal(got, want), (tuple(got.shape), y_offset, bits)


@pytest.mark.cuda
def test_kernel_word_widths_radii_and_edges(card):
    """Census words of 24 and 62 bits; bases that throw windows past every
    edge of the second image; radius 1 (9 labels in 16 and 32 slots) and
    radius 4 (81 in 96); one launch a call."""
    for bits in (24, 62):
        for r, nl_pad in ((1, 16), (1, 32), (4, 96)):
            c1, c2, bu, bv = _inputs(3, 37, 83, r, bits, spread=45,
                                     seed=bits + r, dev=card)
            _check_card((c1, c2, bu, bv, r, 255, nl_pad), bits=bits)
            _check_card((c1, c2, bu, bv, r, 9, nl_pad), bits=bits)


@pytest.mark.cuda
def test_kernel_level3_slices_and_a_row_tile(card):
    """16 slices of config 4's level 3 (46x155); a row tile (radius 4 halo
    rows, y_offset 40, a 120-row second image) equal to the untiled
    kernel's rows; refusals of a non-contiguous census."""
    c1, c2, bu, bv = _inputs(16, 46, 155, 4, spread=6, seed=3, dev=card)
    _check_card((c1, c2, bu, bv, 4, 255, 96))
    c1, c2, bu, bv = _inputs(2, 120, 131, 4, spread=6, seed=4, dev=card)
    whole = fc.flow_cost(c1, c2, bu, bv, 4, 255, 96, census_bits=24)
    lo, hi = 40, 80
    tile = (c1[:, lo:hi].contiguous(), c2, bu[:, lo - 4:hi + 4].contiguous(),
            bv[:, lo - 4:hi + 4].contiguous(), 4, 255, 96)
    _check_card(tile, y_offset=lo)
    assert torch.equal(fc.flow_cost(*tile, y_offset=lo, census_bits=24),
                       whole[:, lo:hi])
    with pytest.raises(ValueError, match="contiguous"):
        fc.flow_cost(c1[:, lo:hi], *tile[1:], y_offset=lo)
