"""PyTorch port: K4 (csrc/extract_flow.cu) and min16_probe
(csrc/min16_probe.cu) against their plain versions on the card, at the
edges of their designs.

K4 stages groups of 32 pixels through a per-warp cp.async ring, reduces
each pixel's 16-byte chunks, masks the pad labels of the last real chunk
and stores a group's seven planes as one line a plane; min16_probe moves
16-byte vectors with a scalar head and tail.  Every test here needs an
NVIDIA card (the kernels have no CPU mode) and skips without one;
tests/test_torch_k4_plan.py holds the host-side logic on the CPU.  Each
case is bit for bit.
"""

import numpy as np
import pytest
import torch

from fsgm_tpu_torch.ops.kernels import extract, probe

GRIDS = (3, 5, 9, 15)  # label grids: D = 32, 32, 96, 256


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _check_k4(s, e):
    nl = e * e
    for sub in (True, False):
        got = extract.extract_flow(s, nl, e, sub)
        want = extract.extract_flow_plain(s, nl, e, sub)
        got = (got[0],) + ((got[1] + got[2]) if sub else ())
        want = (want[0],) + ((want[1] + want[2]) if sub else ())
        for g, w in zip(got, want):
            assert torch.equal(g, w), (tuple(s.shape), s.dtype, e, sub)


def _volume(shape, e, dtype, lo, hi, pad, seed):
    rng = np.random.default_rng(seed)
    nl = e * e
    nd = -(-nl // 32) * 32
    s = np.full(shape + (nd,), pad, dtype)
    s[..., :nl] = rng.integers(lo, hi, shape + (nl,))
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_k4_label_grids_and_ragged_groups(card, dtype):
    """e = 3, 5, 9, 15 (D = 32 ... 256) at W = 1, 53 and 1242 (pixel
    counts not a multiple of 32: a ragged last group), random S with pad
    slots below every real value."""
    for e in GRIDS:
        for h, w in ((5, 1), (3, 53), (7, 1242)):
            s = _volume((h, w), e, dtype, 0, 2841, -1, seed=e * w)
            _check_k4(torch.from_numpy(s).to(card), e)


@pytest.mark.cuda
def test_k4_ties_inside_and_across_chunks(card):
    """Values in [0, 3): many ties, inside a 16-byte chunk and across
    chunk boundaries; and a plane whose minimum sits at the last label of
    one chunk and the first of the next in every pixel."""
    for dtype in (np.int16, np.int32):
        per_chunk = 16 // np.dtype(dtype).itemsize
        for e in GRIDS:
            s = _volume((9, 67), e, dtype, 0, 3, 0, seed=e)
            _check_k4(torch.from_numpy(s).to(card), e)
            nl = e * e
            s = _volume((4, 45), e, dtype, 50, 60, 0, seed=e + 1)
            for c in range(per_chunk, nl, per_chunk):
                t = s.copy()
                t[..., c - 1:c + 1] = 7
                got = extract.extract_flow(torch.from_numpy(t).to(card), nl,
                                           e)[0]
                assert bool((got == c - 1).all()), (dtype, e, c)
                _check_k4(torch.from_numpy(t).to(card), e)


@pytest.mark.cuda
def test_k4_pads_and_largest_values(card):
    """Pad slots at the type's smallest value against real labels at its
    largest (int16: 32767, where the kernel's pad mask ties a real label;
    int32: S = 2^23 - 1, the packed key's edge); S of one value with the
    smallest label the answer."""
    for e in GRIDS:
        nl = e * e
        s16 = _volume((3, 70), e, np.int16, 32760, 32768, -32768, seed=e)
        s16[0] = 32767
        s16[0, :, nl:] = -32768
        _check_k4(torch.from_numpy(s16).to(card), e)
        got = extract.extract_flow(torch.from_numpy(s16).to(card), nl, e)[0]
        assert not bool(got[0].any())
        s32 = _volume((3, 70), e, np.int32, (1 << 23) - 4, 1 << 23,
                      -(1 << 31), seed=e)
        s32[1] = (1 << 23) - 1
        _check_k4(torch.from_numpy(s32).to(card), e)


@pytest.mark.cuda
def test_k4_refuses_a_misaligned_s(card):
    """An S view 2 bytes off a 16-byte boundary raises; one pixel off (a
    multiple of 64 bytes) runs."""
    flat = torch.zeros(3 * 40 * 32 + 32, dtype=torch.int16, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        extract.extract_flow(flat[1:1 + 3 * 40 * 32].view(3, 40, 32), 25, 5)
    s = flat[32:].view(3, 40, 32)
    _check_k4(s, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("form", probe.FORMS)
def test_min16_counts_and_offsets(card, form):
    """n = 0, 1, 7, 9 and 2^20 + 3 (packed: the even counts next to them;
    odd n raises), inputs at every offset 0-7 elements from a 16-byte
    boundary (packed: even offsets), a and b at the same and at different
    offsets (the one-unit path)."""
    dtype = torch.int32 if form == "int32" else torch.int16
    rng = np.random.default_rng(1)
    big = (1 << 20) + 20
    a, b = (torch.from_numpy(rng.integers(-32768, 32768, big)).to(dtype)
            .to(card) for _ in range(2))
    a[:2] = torch.tensor([-32768, 32767])
    b[:2] = torch.tensor([32767, -32768])
    packed = form == "packed"
    counts = (0, 2, 8, 10, (1 << 20) + 4) if packed else (
        0, 1, 7, 9, (1 << 20) + 3)
    for n in counts:
        for off in range(0, 8, 2 if packed else 1):
            for off_b in {off, (off + 2) % 8}:
                x, y = a[off:off + n], b[off_b:off_b + n]
                got = probe.min_probe(x, y, form)
                assert torch.equal(got, torch.minimum(x, y)), (n, off, off_b)
    if packed:
        with pytest.raises(ValueError, match="even count"):
            probe.min_probe(a[:9], b[:9], form)
