"""PyTorch port: the host-side plan of K2 (csrc/sgm_sweep.cu) on the CPU.

K2 carries its labels as packed unsigned 16-bit pairs where packed16
holds, sizes a ring of steps in shared memory from D and the S type
(ring_plan, a mirror of csrc/sgm_walk.cuh), and aggregate_paths chooses
between its two launch forms from the kernel's own resident warps
(uses_family_launch).  The kernel itself runs only on the card
(tests/test_torch_k2_card.py); here the predicate, the plan, the build hash
and the launch rule are held to what the source and the presets say, and a
numpy model of the packed arithmetic is held to sgm_sweep_plain at the
predicate's edge.
"""

import re
import shutil

import numpy as np
import pytest
import torch

from fsgm_tpu_torch import load_preset
from fsgm_tpu_torch.ops.kernels import _build
from fsgm_tpu_torch.ops.kernels import aggregate as agg

WALK = _build.SRC_DIR / "sgm_walk.cuh"


def _preset_case(name):
    """(S dtype, D, P1, P2' bound) that aggregate_paths hands K2."""
    if name == "config 4":
        p = load_preset("configs/kitti_flow.json")["flow"]
        nd = -(-p.num_labels // 32) * 32
        return (agg.plan_dtypes(8 * (p.invalid_cost + p.p2)), nd, p.p1,
                agg.p2_bound(p.p1, p.p2))
    path = {"KITTI": "configs/kitti_stereo.json",
            "config 1": "configs/tsukuba.json"}.get(name)
    p = load_preset(path)["sgm"] if path else load_preset(
        "configs/kitti_stereo.json")["sgm"].__class__(p2=7000)
    return (agg.plan_dtypes(p.s_invalid), p.max_disp, p.p1,
            agg.p2_bound(p.p1, p.p2))


@pytest.mark.parametrize("name,packed", [
    ("edge", True), ("KITTI", True), ("config 1", True),
    ("config 4", False), ("p2 = 7000", False)])
def test_packed16_predicate(name, packed):
    """Packed labels for int16 S, D/32 even, 0 <= P1 <= PACKED_P1_MAX and a
    P2' bound up to PACKED_P2_MAX: KITTI (D=128) and config 1 (D=64) take
    them, config 4 (81 labels in 96 slots, K = 3) and p2 = 7000 (int32 S)
    take int32 labels; at the edge one more of P1 or P2' leaves them."""
    if name == "edge":
        p1, p2 = agg.PACKED_P1_MAX, agg.PACKED_P2_MAX
        assert 255 + 2 * p2 <= agg.SENTINEL and agg.SENTINEL + p1 == 0xFFFF
        assert agg.packed16(torch.int16, 64, p1, p2)
        assert not agg.packed16(torch.int16, 64, p1 + 1, p2)
        assert not agg.packed16(torch.int16, 64, p1, p2 + 1)
        assert not agg.packed16(torch.int16, 64, -1, p2)
        assert not agg.packed16(torch.int16, 64, p1, None)
        assert not agg.packed16(torch.int16, 96, p1, p2)
        assert not agg.packed16(torch.int32, 64, p1, p2)
        return
    s_dtype, nd, p1, p2_max = _preset_case(name)
    assert agg.packed16(s_dtype, nd, p1, p2_max) == packed
    assert (s_dtype == torch.int32) == (name == "p2 = 7000")


def _packed_model(cost, p2e, p1, nl):
    """L of direction (0, 1) as K2's packed halves compute it, one value per
    half in int64, asserting that no half leaves [0, 0xFFFF] (a carry or a
    borrow into the next half); pad slots hold SENTINEL and give 0."""
    s0 = agg.SENTINEL
    h, w, nd = cost.shape
    real = np.arange(nd) < nl

    def half(a):
        assert a.min() >= 0 and a.max() <= 0xFFFF
        return a

    out = np.zeros((h, w, nd), np.int64)
    prev = None
    for x in range(w):
        c = cost[:, x].astype(np.int64)
        if prev is None:
            lab = np.where(real, c, s0)
        else:
            m = prev.min(-1, keepdims=True)
            edge = np.full((h, 1), s0)
            left = np.concatenate([edge, prev[:, :-1]], -1)
            right = np.concatenate([prev[:, 1:], edge], -1)
            nbp = np.minimum(half(left + p1), half(right + p1))
            mp = half(m + p2e[:, x, None])
            best = np.minimum(np.minimum(prev, nbp), mp)
            lab = np.where(real, half(half(best + c) - m), s0)
        out[:, x] = np.where(real, lab, 0)
        prev = lab
    return out


def test_packed_arithmetic_at_the_edge():
    """At P1 = PACKED_P1_MAX and P2' = PACKED_P2_MAX with costs up to 255
    the packed halves stay in range and give sgm_sweep_plain's L bit for
    bit, pad slots included; one more P1 carries out of a half."""
    rng = np.random.default_rng(6)
    h, w, nd, nl = 5, 40, 64, 61
    cost = rng.integers(0, 256, (h, w, nd)).astype(np.uint8)
    cost[:, ::3, ::5] = 255
    p1, p2 = agg.PACKED_P1_MAX, agg.PACKED_P2_MAX
    p2e = np.full((h, w), p2, np.int32)
    want = agg.sgm_sweep_plain(torch.from_numpy(cost), torch.from_numpy(p2e),
                               (0, 1), p1, nl=nl)
    np.testing.assert_array_equal(_packed_model(cost, p2e, p1, nl),
                                  want.numpy())
    with pytest.raises(AssertionError):
        _packed_model(cost, p2e, p1 + 1, nl)


def test_ring_plan_fits_every_width():
    """D = 32 ... 256, int16 and int32 S, every launch mode and label rule:
    a power-of-two ring of 4 to 16 steps whose block fits the 48 KB of
    static shared memory (and so the 227 KB an H100 block can have)."""
    for nd in range(32, 257, 32):
        for s_dtype in (torch.int16, torch.int32):
            for mode in agg.MODES:
                for two_d in (False, True):
                    for packed in {False, agg.packed16(s_dtype, nd, 7, 101)}:
                        plan = agg.ring_plan(nd, s_dtype, mode, two_d, packed)
                        steps = plan["steps"]
                        assert 4 <= steps <= agg.RING_MAX
                        assert steps & (steps - 1) == 0
                        assert plan["block_bytes"] <= 48 * 1024 < 227 * 1024
    assert agg.ring_plan(128, torch.int16, "accum")["steps"] == 16
    assert agg.ring_plan(256, torch.int32, "accum")["steps"] == 8


def test_ring_plan_mirrors_the_source():
    """ring_plan's constants and formula are csrc/sgm_walk.cuh's."""
    src = WALK.read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\w+)", src)
                   .group(1).rstrip("u"), 0)

    assert const("kRingBudget") == agg.RING_BUDGET
    assert const("kMaxRing") == agg.RING_MAX
    assert const("kThreads") // 32 == agg.WARPS_PER_BLOCK
    assert const("kSentinel") == agg.SENTINEL
    assert "n > 4 && n * 32 * k * (1 + sb) > kRingBudget" in src
    assert "return 32 * k * (1 + (mode == kAccum ? sb : 0));" in src


def test_build_digest_covers_headers(tmp_path):
    """The library's hash changes with sgm_sweep.cu, with the header it
    includes and with a header that header includes, and not with a
    header nothing includes."""
    for f in _build.SRC_DIR.iterdir():
        shutil.copy(f, tmp_path / f.name)
    src = tmp_path / "sgm_sweep.cu"
    assert _build.included_headers(src) == [tmp_path / "cp_async.cuh",
                                            tmp_path / "sgm_walk.cuh"]
    base = _build.source_digest(src)
    (tmp_path / "unused.cuh").write_text("// nothing includes this\n")
    assert _build.source_digest(src) == base
    walk = tmp_path / "sgm_walk.cuh"
    walk.write_text(walk.read_text() + "\n// edited\n")
    edited = _build.source_digest(src)
    assert edited != base
    (tmp_path / "deeper.cuh").write_text("// one\n")
    walk.write_text(walk.read_text() + '#include "deeper.cuh"\n')
    nested = _build.source_digest(src)
    (tmp_path / "deeper.cuh").write_text("// two\n")
    assert len({base, edited, nested, _build.source_digest(src)}) == 4


def test_p2_bound_covers_every_table():
    """p2_bound(p1, p2) bounds every P2' table p2_effective gives, adaptive
    or not and with P1 above P2, and is None where a table may hold a
    negative value; on the CPU a bound changes nothing in the result."""
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.integers(0, 256, (2, 9, 14)).astype(np.uint8))
    cost = torch.from_numpy(rng.integers(0, 40, (2, 9, 14, 64))
                            .astype(np.uint8))
    for p1, p2 in ((7, 100), (7, 7000), (120, 60), (0, 0)):
        for adaptive in (False, True):
            for r in ((0, 1), (1, -1), (-2, 1)):
                t = agg.p2_effective(img, r, p1, p2, adaptive)
                assert 0 <= int(t.min()) and int(t.max()) <= agg.p2_bound(
                    p1, p2)
    assert agg.p2_bound(7, -1) is None and agg.p2_bound(-1, 100) is None
    p2e = agg.p2_effective(img, (1, 1), 7, 100, True)
    assert torch.equal(
        agg.sgm_sweep(cost, p2e, (1, 1), 7, p2_max=agg.p2_bound(7, 100)),
        agg.sgm_sweep(cost, p2e, (1, 1), 7))
