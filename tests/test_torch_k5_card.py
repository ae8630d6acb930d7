"""PyTorch port: K5 (csrc/transpose.cu, label_minor_from_major) against its
plain version on the card, at the edges of its design.

The tiled kernel (L a multiple of 16 up to 256) stages each label row's
128 columns from the aligned 16-byte chunks that cover them at the row's
shift, reads a chunk that leaves the tensor byte by byte, exchanges 4 x 4
byte blocks in registers and writes a tile's output span from a staged
copy; one block a tile, by a flat index.  Other L take the generic
kernel.  Every test here needs an NVIDIA card (the kernels have no CPU
mode) and skips without one; tests/test_torch_k5_plan.py holds the
host-side logic and a model of the tiled kernel on the CPU.  Each case is
bit for bit (maximum error 0).
"""

import pytest
import torch

from fsgm_tpu_torch.ops.kernels import _build, transpose

WIDTHS = tuple(range(1, 34)) + (53, 155, 310, 621, 1242, 3840)
LEVELS = ((375, 1242), (187, 621), (93, 310), (46, 155))  # config 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _volume(shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=gen, device=dev,
                         dtype=torch.uint8)


def _check(vol):
    got = transpose.label_minor_from_major(vol)
    want = transpose.label_minor_from_major_plain(vol)
    assert got.is_contiguous() and torch.equal(got, want), \
        (tuple(vol.shape), vol.data_ptr() % 16)


@pytest.mark.cuda
@pytest.mark.parametrize("nl", [32, 96, 128])
def test_k5_every_row_shift_and_the_paths_widths(card, nl):
    """W = 1 ... 33 (every row shift 0-15, ragged tiles of 1-33 columns)
    and the flow paths' widths 53 ... 3840 (several tiles a row, a ragged
    last tile), 3 rows."""
    for w in WIDTHS:
        _check(_volume((3, nl, w), w, card))


@pytest.mark.cuda
def test_k5_config4_levels_and_the_4k_flow_tile(card):
    """The shapes the flow paths give K5: config 4's four levels and the
    4K flow leg's 720x3840 level-0 tile, 96 label slots."""
    for k, (h, w) in enumerate(LEVELS + ((720, 3840),)):
        _check(_volume((h, 96, w), k, card))


@pytest.mark.cuda
def test_k5_other_label_counts(card):
    """The tiled kernel's label-group edges (L = 16, 48, 240, 256) and the
    generic kernel's L (81 and 7: not a multiple of 16; 272: past 256),
    each with W = 1, 17 and 155."""
    for nl in (16, 48, 240, 256, 81, 7, 272):
        assert transpose.tiled(nl) == (nl % 16 == 0 and nl <= 256)
        for w in (1, 17, 155):
            _check(_volume((2, nl, w), nl + w, card))


@pytest.mark.cuda
def test_k5_one_row_and_more_than_65535_rows(card):
    """H = 1, and H = 70,000 on thin volumes in both kernels (the flat
    tile index has no grid-dimension limit)."""
    _check(_volume((1, 96, 1242), 1, card))
    for nl, w in ((16, 3), (32, 1), (7, 2)):
        _check(_volume((70000, nl, w), nl, card))


@pytest.mark.cuda
def test_k5_any_base_address(card):
    """Views 0 ... 15 bytes past a 16-byte boundary, placed at the end of
    their buffer: the first and last chunks leave the tensor, and its last
    byte is not on a 16-byte boundary."""
    for nl, w in ((96, 53), (32, 1242), (16, 5)):
        n = 3 * nl * w
        for k in range(16):
            buf = _volume((k + n,), k, card)
            assert buf.data_ptr() % 16 == 0
            _check(buf[k:].view(3, nl, w))


@pytest.mark.cuda
def test_k5_on_a_side_stream(card):
    """A launch on a side stream runs on that stream (the wrapper passes
    _build.stream_of), ordered after the volume's producer there."""
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        assert _build.stream_of(torch.empty(1, device=card)) == \
            side.cuda_stream
        vol = _volume((5, 96, 310), 7, card)
        got = transpose.label_minor_from_major(vol)
        want = transpose.label_minor_from_major_plain(vol)
    side.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k5_counts_one_launch_and_refuses_strided_volumes(card):
    """One launch counted a call; a non-contiguous CUDA volume raises (no
    plain fallback)."""
    vol = _volume((4, 96, 64), 3, card)
    _build.LAUNCHES.clear()
    transpose.label_minor_from_major(vol)
    assert _build.LAUNCHES["label_minor_from_major"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        transpose.label_minor_from_major(vol[:, :, ::2])
    assert _build.LAUNCHES["label_minor_from_major"] == 1
