"""PyTorch port: the host-side side of K4 (csrc/extract_flow.cu) and
min16_probe (csrc/min16_probe.cu) on the CPU.

K4 stages groups of 32 pixels through a per-warp ring in shared memory and
reads 16-byte chunks of each staged row; min16_probe moves 16 bytes a
thread a step and places its output at its first input's offset from a
16-byte boundary.  The kernels run only on the card
(tests/test_torch_k4_card.py); here the constants the wrappers share with
the sources are read from the sources, K4's staged rows are held to their
conflict-free stride, the wrappers' refusals are held to the kernels'
contracts, and K4's plain version is held to the JAX package's
extract_flow_major (interpret mode) with ties across a 16-byte chunk
boundary, at the label grids the card tests use.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsgm_tpu.ops.pallas.extract_tr import extract_flow_major
from fsgm_tpu_torch.ops.kernels import _build, extract, probe


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_k4_staged_rows_are_conflict_free():
    """K4_CHUNK is extract_flow.cu's kChunk (the wrapper's alignment), and
    for D = 32 ... 256 in int16 and int32 S a staged pixel row (D values
    and kRowPad bytes) is an odd count of 16-byte chunks: eight
    consecutive lanes reading one chunk each hit all 32 banks once."""
    src = (_build.SRC_DIR / "extract_flow.cu").read_text()
    assert _const(src, "kChunk") == extract.K4_CHUNK == 16
    assert "uint4" in src and "cp_async16" in src
    pad = _const(src, "kRowPad")
    assert "return kGroup * (pb + kRowPad);" in src
    for nd in range(32, 257, 32):
        for elem in (2, 4):
            assert (nd * elem + pad) % extract.K4_CHUNK == 0
            assert (nd * elem + pad) // extract.K4_CHUNK % 2 == 1, (nd, elem)


def test_min16_constants_mirror_the_source():
    """VECTOR_BYTES is min16_probe.cu's kVector; at least two vectors a
    thread are in flight."""
    src = (_build.SRC_DIR / "min16_probe.cu").read_text()
    assert _const(src, "kVector") == probe.VECTOR_BYTES == 16
    assert _const(src, "kUnroll") >= 2
    assert "resident_blocks" in src and "__vmins2" in src


def test_k4_refusals():
    """The kernel's S check refuses a view off a 16-byte boundary, D not a
    multiple of 32 and D past 256; the wrapper refuses nl != e^2, nl > 255,
    e < 3 and nl past D on any device."""
    base = torch.zeros(4 * 5 * 32 + 8, dtype=torch.int16)
    aligned = base[:4 * 5 * 32].view(4, 5, 32)
    extract.check_flow_kernel_input(aligned)
    k = (16 - aligned.data_ptr() % 16) % 16 // 2 or 1
    for bad in (base[k:k + 4 * 5 * 32].view(4, 5, 32),
                torch.zeros((4, 5, 48), dtype=torch.int16),
                torch.zeros((2, 3, 288), dtype=torch.int32),
                torch.zeros((4, 5, 64), dtype=torch.int16)[..., :32]):
        with pytest.raises(ValueError, match="16-byte"):
            extract.check_flow_kernel_input(bad)
    s = torch.zeros((3, 4, 256), dtype=torch.int16)
    for nl, e in ((16, 5), (24, 5), (256, 16), (4, 2), (64, 8)):
        with pytest.raises(ValueError, match="label_ext"):
            extract.extract_flow(s[..., :32] if nl == 64 else s, nl, e)


def test_min16_refusals_and_output_offset():
    """packed refuses an odd count and a view off a 4-byte boundary, and
    int32 tensors; the output sits at the first input's offset from a
    16-byte boundary; the CPU answer is torch.minimum."""
    a = torch.arange(40, dtype=torch.int16)
    b = torch.flip(a, [0])
    with pytest.raises(ValueError, match="even count"):
        probe.min_probe(a[:9], b[:9], "packed")
    off = 1 if a.data_ptr() % 4 == 0 else 2
    with pytest.raises(ValueError, match="aligned to 4 bytes"):
        probe.min_probe(a[off:off + 8], b[off:off + 8], "packed")
    with pytest.raises(TypeError):
        probe.min_probe(a.int(), b.int(), "packed")
    for k in range(8):
        x = a[k:k + 17]
        out = probe._output_like(x)
        assert out.shape == x.shape and out.dtype == x.dtype
        assert out.data_ptr() % 16 == x.data_ptr() % 16
        for form in ("minsi", "select", "widen"):
            assert torch.equal(probe.min_probe(x, b[k:k + 17], form),
                               torch.minimum(x, b[k:k + 17]))


def _tie_volume(e, dtype, seed):
    """(H, W, D) S with nl = e^2 labels: random values, then per pixel the
    minimum planted at two labels that straddle a 16-byte chunk boundary
    (or sit inside one chunk), and pad slots below every real value."""
    rng = np.random.default_rng(seed)
    nl = e * e
    nd = -(-nl // 32) * 32
    per_chunk = 16 // np.dtype(dtype).itemsize
    s = np.full((6, 29, nd), -7, dtype)
    s[..., :nl] = rng.integers(10, 60, (6, 29, nl))
    bounds = [c for c in range(per_chunk, nl, per_chunk)]
    for y in range(6):
        for x in range(29):
            if bounds and (y + x) % 3:
                c = bounds[(y * 29 + x) % len(bounds)]
                lo, hi = c - 1, c  # across the boundary
            else:
                lo = int(rng.integers(0, nl - 1))
                hi = lo + 1
            s[y, x, [lo, hi]] = rng.integers(0, 3)
    return s


@pytest.mark.parametrize("e,dtype", [(3, np.int32), (3, np.int16),
                                     (5, np.int16), (9, np.int16),
                                     (9, np.int32), (15, np.int32)])
def test_extract_flow_plain_matches_jax_with_chunk_ties(e, dtype):
    """extract_flow_plain == JAX extract_flow_major (interpret mode) with
    subpixel, l* the first of two tied labels, pads ignored."""
    s = _tie_volume(e, dtype, seed=e)
    nl = e * e
    want = extract_flow_major(jnp.asarray(s[..., :nl].transpose(0, 2, 1)),
                              e, with_sub=True)
    ours = extract.extract_flow(torch.from_numpy(s), nl, e, True)
    first = np.argmin(s[..., :nl], axis=-1)
    np.testing.assert_array_equal(ours[0].numpy(), first)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(want[0]))
    for got, ref in zip(ours[1] + ours[2], want[1] + want[2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
