"""PyTorch port: K1 (csrc/cost.cu) and K3 (csrc/extract.cu) against their
plain versions on the card, at the edges of their designs.

K1 makes 16-label groups from a staged tile of census words (32-bit words
where census_bits <= 32, 64-bit ones otherwise); K3 stages S through a
cp.async ring, scatters the right view into shared memory and writes its
planes at the row's end.  Every test here needs an NVIDIA card (the
kernels have no CPU mode) and skips without one; tests/test_torch_k13_plan.py
holds the host-side logic on the CPU.  Each case is bit for bit.
"""

import numpy as np
import pytest
import torch

from fsgm_tpu_torch.ops.kernels import cost, extract


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _census(dev, shape, bits, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << bits, shape, dtype=np.int64)
    return torch.from_numpy(words).to(dev)


def _check_k1(cl, cr, nd, bits, invalid=255):
    for rr in (False, True):
        for b in {bits, 64}:
            got = cost.census_cost(cl, cr, nd, invalid, rr, b)
            want = cost.census_cost_plain(cl, cr, nd, invalid, rr, b)
            assert torch.equal(got, want), (tuple(cl.shape), nd, rr, b)


@pytest.mark.cuda
def test_k1_ragged_label_groups(card):
    """D = 20 (a group cut at 4 labels, unaligned rows) and D = 48 (one
    group of the second pair past D), both references, 32- and 64-bit
    words, on tiles cut by the row's end."""
    for nd in (20, 48):
        c = _census(card, (2, 7, 301), 24, nd)
        _check_k1(c[0], c[1], nd, 24, 200)


@pytest.mark.cuda
def test_k1_unaligned_rows_and_census(card):
    """W * D not a multiple of 16 (D = 1, 5, 33 at an odd W) and census
    tensors that start 8 bytes off a 16-byte boundary (the one-word
    staging path)."""
    c = _census(card, (2, 5 * 39 + 1), 24, 3)
    cl, cr = c[0, 1:].view(5, 39), c[1, 1:].view(5, 39)
    assert cl.data_ptr() % 16 == 8
    for nd in (1, 5, 33):
        _check_k1(cl, cr, nd, 24)


@pytest.mark.cuda
def test_k1_right_reference_three_frames(card):
    """B = 3 frames in one launch, right reference at D = 128, frames that
    differ."""
    cl = _census(card, (3, 9, 260), 24, 4)
    cr = _census(card, (3, 9, 260), 24, 5)
    got = cost.census_cost(cl, cr, 128, 255, True, 24)
    assert torch.equal(got, cost.census_cost_plain(cl, cr, 128, 255, True,
                                                   24))
    for k in range(3):
        assert torch.equal(got[k], cost.census_cost(cl[k], cr[k], 128, 255,
                                                    True, 24))


@pytest.mark.cuda
def test_k1_wide_census_words(card):
    """9x7 census: 62-bit words take the 64-bit path (two popcounts a
    byte); told 62 bits, the kernel gives the 64-bit result."""
    from fsgm_tpu_torch.ops.census import census_transform
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.integers(0, 256, (2, 11, 150),
                                        dtype=np.uint8)).to(card)
    c = census_transform(img, (9, 7))
    _check_k1(c[0], c[1], 64, 62)


@pytest.mark.cuda
def test_k1_tile_edges_and_wide_rows(card):
    """Rows of 1, 127, 128, 129 and 20000 columns (one tile short of, at
    and past a tile, and 157 tiles), D = 256 (the widest halo) and 32."""
    for w in (1, 127, 128, 129, 20000):
        c = _census(card, (2, 2, w), 24, w)
        for nd in (32, 256):
            _check_k1(c[0], c[1], nd, 24)


def _s(dev, shape, dtype, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(
        np.int16 if dtype == torch.int16 else np.int32)).to(dev)


def _check_k3(s, s_invalid, **kw):
    for rwta in (True, False):
        for sub in (True, False):
            got = extract.extract_stereo(s, s_invalid, 1, sub, rwta, **kw)
            want = extract.extract_stereo_plain(s, s_invalid, 1, sub, rwta,
                                                **kw)
            for g, w_ in zip(got, want):
                assert (g is None and w_ is None) or torch.equal(g, w_), (
                    tuple(s.shape), s.dtype, rwta, sub, kw)
    if not kw:
        assert torch.equal(extract.wta_right(s, s_invalid),
                           extract.wta_right_plain(s, s_invalid))


@pytest.mark.cuda
def test_k3_label_counts_and_types(card):
    """K = 1 and 8 (D = 32 and 256) in int16 and int32 S: the shallowest
    and deepest rings; 2 frames of rows not a multiple of 16 pixels."""
    for dtype in (torch.int16, torch.int32):
        for nd, w in ((32, 77), (256, 45)):
            s = _s(card, (2, 5, w, nd), dtype, 0, 900, nd)
            _check_k3(s, 2000)


@pytest.mark.cuda
def test_k3_ties_and_s_invalid_minimum(card):
    """All-equal S (every minimum a tie: smallest d wins, in the left and
    the right view) and S whose row minimum is s_invalid itself (the right
    view's out-of-image key ties with or beats every in-image one)."""
    nd = 64
    s = torch.full((3, 70, nd), 37, dtype=torch.int16, device=card)
    _check_k3(s, 37)
    _check_k3(s, 900)
    s = _s(card, (3, 70, nd), torch.int16, 500, 530, 2)
    _check_k3(s, 500)


@pytest.mark.cuda
def test_k3_window_columns(card):
    """Windows with gx0 < 0 and with gx0 + W > w_global (columns outside
    the image on either side), int16 and int32 S."""
    for dtype in (torch.int16, torch.int32):
        s = _s(card, (2, 3, 90, 64), dtype, 0, 700, 5)
        for gx0, wg in ((-20, 60), (30, 100), (-10, 50), (0, 90)):
            _check_k3(s, 1000, gx0=gx0, w_global=wg)


@pytest.mark.cuda
def test_k3_at_max_width(card):
    """W = MAX_WIDTH (the shared-memory planes fill a block with the
    deepest ring: int32 S at D = 256) and MAX_WIDTH_RIGHT for wta_right;
    one column more raises."""
    w = extract.MAX_WIDTH
    _check_k3(_s(card, (2, w, 32), torch.int16, 0, 900, 8), 2000)
    _check_k3(_s(card, (1, w, 256), torch.int32, 0, 900, 9), 2000)
    s = _s(card, (1, extract.MAX_WIDTH_RIGHT, 32), torch.int16, 0, 900, 10)
    assert torch.equal(extract.wta_right(s, 2000),
                       extract.wta_right_plain(s, 2000))
    with pytest.raises(ValueError):
        extract.extract_stereo(torch.zeros((1, w + 1, 32), dtype=torch.int16,
                                           device=card), 2000)
