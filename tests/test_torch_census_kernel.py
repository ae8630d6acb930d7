"""PyTorch port: K7 census (csrc/census.cu), the census transform of an
image batch in one launch.

On the CPU, census_transform takes census_transform_plain; here it is held
to it over dtypes and leading axes, the argument checks are held to raise
the same errors on both routes (a meta tensor stands for the card's route:
it passes the checks and reaches the kernel's wrapper), and a Python model
of the kernel's tiling (block -> frame and tile, staged region with its
clamped halo, warp -> rows, lane -> column pair, the store guards) is held
to the plain version, with the source's constants read from the source.
Tests marked ``cuda`` hold the kernel to the plain version bit for bit on
the card and skip without one.
"""

import re

import numpy as np
import pytest
import torch

from fsgm_tpu_torch.ops import census
from fsgm_tpu_torch.ops.kernels import _build
from fsgm_tpu_torch.utils import tracing

torch.set_num_threads(1)

SRC = (_build.SRC_DIR / "census.cu").read_text()
FLOW_LEVELS = [(375 >> k, 1242 >> k) for k in range(4)]  # config 4's pyramid


def _const(name: str) -> int:
    """A constexpr int of the source, its expression evaluated over the
    ones before it."""
    env = {}
    for key, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", SRC):
        env[key] = eval(expr.replace("/", "//"), {}, env)
    return env[name]


def _images(shape, dtype=np.uint8, seed=0, lo=0, hi=256):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _model(img: np.ndarray, window) -> np.ndarray:
    """csrc/census.cu's arithmetic, block by block and thread by thread, in
    numpy: every output pixel written once (-1 marks one never written)."""
    th, tw = _const("kTileH"), _const("kTileW")
    warps, rows = _const("kThreads") // 32, _const("kRows")
    ch, cw = window
    ry, rx = ch // 2, cw // 2
    n_, h, w = img.shape
    sh, sw = th + 2 * ry, tw + 2 * rx
    diff = img.dtype == np.uint8 and (ch, cw) == (5, 5)  # its unrolled form
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    out = np.full((n_, h, w), -1, np.int64)
    writes = np.zeros((n_, h, w), np.int64)
    for tile in range(n_ * tiles_y * tiles_x):
        tx, rest = tile % tiles_x, tile // tiles_x
        ty, n = rest % tiles_y, rest // tiles_y
        y0, x0 = ty * th, tx * tw
        q = np.arange(sh * sw)                 # staging: a flat order
        i, j = q // sw, q % sw
        stage = img[n, np.clip(y0 - ry + i, 0, h - 1),
                    np.clip(x0 - rx + j, 0, w - 1)].astype(np.int32)
        stage = stage.astype(np.int64).reshape(sh, sw)
        for warp in range(warps):
            for r in range(rows):
                t = warp * rows + r            # tile row
                c = 2 * np.arange(32)[:, None] + np.arange(2)  # lane, pair
                cen = stage[t + ry, c + rx]
                word, bit = np.zeros_like(cen), 0
                for oy in range(ch):
                    for ox in range(cw):
                        if (oy, ox) == (ry, rx):
                            continue
                        nb = stage[t + oy, c + ox]
                        if diff:    # uint8, <= 24 bits: bit b + 8 of nb - c
                            word |= (nb - cen) & (1 << (bit + 8))
                        else:
                            word |= (nb < cen).astype(np.int64) << bit
                        bit += 1
                if diff:
                    word >>= 8
                y, x = y0 + t, x0 + c
                if y >= h:
                    continue
                keep = x < w
                out[n, y, x[keep]] = word[keep]
                writes[n, y, x[keep]] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("shape,window,dtype", [
    ((2, 37, 70), (5, 5), np.uint8),     # ragged in both tile axes
    ((1, 45, 131), (9, 7), np.int32),    # 62 bits, odd W, int32 pixels
    ((3, 3, 4), (9, 7), np.uint8),       # smaller than the window
    ((1, 33, 65), (1, 63), np.uint8),    # one tile row and column past
])
def test_kernel_model_matches_the_plain_version(shape, window, dtype):
    """The model of the kernel's tiling equals census_transform_plain; the
    staged region of every legal window fits the default 48 KB of shared
    memory."""
    hi = 1 << 20 if dtype == np.int32 else 256
    img = _images(shape, dtype, seed=sum(shape), lo=-hi if hi > 256 else 0,
                  hi=hi)
    want = census.census_transform_plain(img, window).numpy()
    assert np.array_equal(_model(img.numpy(), window), want)
    th, tw = _const("kTileH"), _const("kTileW")
    assert _const("kMaxBits") == census.MAX_BITS
    assert max(4 * (th + a - 1) * (tw + b - 1)
               for a in range(1, 64, 2) for b in range(1, 64, 2)
               if a * b - 1 <= census.MAX_BITS) <= 48 * 1024


def test_cpu_route_is_the_plain_version():
    """census_transform on CPU tensors is census_transform_plain, inside an
    fsgm.census span that launches nothing, for any integer dtype and any
    leading axes."""
    for dtype in (torch.uint8, torch.int16, torch.int32, torch.int64,
                  torch.bool):
        img = _images((2, 3, 19, 23), seed=1).to(dtype)
        with tracing.recording():
            got = census.census_transform(img)
        recs = tracing.take()
        assert [(r.name, r.launches) for r in recs] == [("fsgm.census", 0)]
        assert got.dtype == torch.int64 and got.shape == img.shape
        assert torch.equal(got, census.census_transform_plain(img))
        assert torch.equal(census.census_transform(img[0, 0], (3, 5)),
                           census.census_transform_plain(img[0, 0], (3, 5)))


def test_argument_checks_raise_the_same_on_both_routes():
    """An even window, one over 62 bits, a float image and a 1-D one raise
    the same error on the CPU route, on the card's route (a meta tensor:
    the checks run before the route is chosen) and in the plain version; a
    legal meta tensor reaches the kernel's wrapper, which takes CUDA
    tensors only, unless ``plain`` (the references' route) sends it to the
    plain version."""
    img = torch.zeros((2, 8, 9), dtype=torch.uint8)
    bad = [(img, (4, 5), ValueError), (img, (5, 6), ValueError),
           (img, (9, 9), ValueError), (img, (3, 23), ValueError),
           (img.float(), (5, 5), TypeError), (img[0, 0], (5, 5), ValueError)]
    for x, window, err in bad:
        said = set()
        for fn, arg in ((census.census_transform, x),
                        (census.census_transform, x.to("meta")),
                        (census.census_transform_plain, x)):
            with pytest.raises(err) as info:
                fn(arg, window)
            said.add(str(info.value))
        assert len(said) == 1, said
    with pytest.raises(ValueError, match="unsupported device"):
        census.census_transform(img.to("meta"), (7, 9))
    got = census.census_transform(img.to("meta"), (7, 9), plain=True)
    assert got.device.type == "meta" and got.dtype == torch.int64


def _check_card(img, window=(5, 5)):
    _build.LAUNCHES.clear()
    got = census.census_transform(img, window)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["census"] == 1
    assert got.dtype == torch.int64 and got.shape == img.shape
    assert got.is_contiguous()
    want = census.census_transform_plain(img, window)
    assert torch.equal(got, want), (tuple(img.shape), img.dtype, window)


@pytest.mark.cuda
def test_kernel_kitti_batch(card):
    """16 KITTI frames in one launch, uint8 and int32 pixels; ``plain``
    launches nothing."""
    img = _images((16, 375, 1242), seed=2).to(card)
    _check_card(img)
    _check_card(img.to(torch.int32) * 4099 - 500_000)
    _build.LAUNCHES.clear()
    plain = census.census_transform(img, plain=True)
    assert not _build.LAUNCHES
    assert torch.equal(plain, census.census_transform(img))


@pytest.mark.cuda
def test_kernel_flow_levels(card):
    """Config 4's four pyramid levels (odd widths at levels 1 and 3) over 16
    slices, and 8 frames of level 3 given as (2, 4, H, W)."""
    for k, (h, w) in enumerate(FLOW_LEVELS):
        _check_card(_images((16, h, w), seed=3 + k).to(card))
    _check_card(_images((2, 4) + FLOW_LEVELS[3], seed=7).to(card))


@pytest.mark.cuda
def test_kernel_windows_dtypes_and_shapes(card):
    """9x7 (62 bits) over uint8 and int32; 3x3, 63x1 and 1x63; one frame
    as (H, W); int16 and int64 pixels (converted, as the plain version
    does); a non-contiguous view; images smaller than the window; an empty
    batch launches nothing."""
    img = _images((4, 100, 131), seed=8).to(card)
    for window in ((9, 7), (3, 3), (63, 1), (1, 63)):
        _check_card(img, window)
    _check_card(_images((4, 100, 131), np.int32, 9, -(1 << 30), 1 << 30)
                .to(card), (9, 7))
    _check_card(_images((375, 1242), seed=10).to(card))
    _check_card(_images((3, 50, 70), np.int16, 11, -300, 300).to(card))
    _check_card(_images((3, 50, 70), np.int64, 12, -(1 << 40), 1 << 40)
                .to(card), (7, 7))
    _check_card(_images((3, 60, 70), seed=13).to(card)[:, 5:45, 3:])
    for shape in ((2, 3, 2), (1, 1, 1), (5, 1, 40)):
        _check_card(_images(shape, seed=14).to(card), (9, 7))
    _build.LAUNCHES.clear()
    empty = census.census_transform(
        torch.zeros((0, 8, 8), dtype=torch.uint8, device=card))
    assert empty.shape == (0, 8, 8) and not _build.LAUNCHES
