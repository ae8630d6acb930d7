"""PyTorch port: K2's family launch (sgm_sweep_family) and when
aggregate_paths takes it.

sgm_sweep_family sweeps several directions in one launch and adds the sum
of their L_r into S.  Its plain version (the CPU path of the wrapper) is
held to the JAX package:

  * fsgm_tpu/ops/pallas/aggregate_tr.py::tr_dual_family_sweep in interpret
    mode (tests/conftest.py sets FSGM_PALLAS_INTERPRET=1) on the vertical
    directions of the 8- and 16-path sets, its (H, L, W) S transposed to
    the port's (H, W, D);
  * the sum of fsgm_tpu/ops/aggregate.py::aggregate_one_path over the down
    family added into a given S (tools/trexp.py::tr_row_family_sweep's
    contract; aggregate_one_path is that tool's plain reference), and over
    the 8 paths with flow's 2D label rule and pad slots.

aggregate_paths takes a group's family launch where family_launch_pays
(few lines against the per-direction kernel's resident warps).  On the CPU
no card is there to fill, so the tests make the rule say yes to make it
take them: stereo_sgm and flow_fsgm then equal their per-direction results
bit for bit.  The kernel itself runs on the card (the `cuda` test
at the end and chip_smoke.py phase 9).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.sgm as g
from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu.ops import aggregate as jagg
from fsgm_tpu.ops.pallas import aggregate_tr as ptr
from fsgm_tpu_torch import (DIRS_8, DIRS_16, FlowParams, SGMParams,
                            flow_fsgm, stereo_sgm)
from fsgm_tpu_torch.io import blockwise_flow_pair
from fsgm_tpu_torch.ops.kernels import aggregate as agg

P1, P2 = 7, 60


def _volume(h, w, d, seed):
    img_l, img_r, _ = random_dot_stereo(h, w, d, seed=seed)
    cost = g.cost_volume_stereo(g.census_transform(img_l),
                                g.census_transform(img_r), d, 255)
    return img_l, cost.astype(np.uint8)


def _tables(img, dirs, adaptive):
    return torch.stack([agg.p2_effective(torch.from_numpy(img), r, P1, P2,
                                         adaptive) for r in dirs])


@pytest.mark.parametrize("dirs,adaptive", [(DIRS_8, False),
                                           (DIRS_16, True)])
def test_family_matches_tr_dual_family_sweep(dirs, adaptive):
    """The vertical group (down and up families) in one launch equals the
    JAX dual-family launch; the JAX test's 40x56x16 volume."""
    img, cost = _volume(40, 56, 16, seed=7)
    down = [r for r in dirs if r[0] > 0]
    up = [r for r in dirs if r[0] < 0]
    s_max = len(dirs) * (255 + P2)
    want = ptr.tr_dual_family_sweep(
        jnp.asarray(cost.transpose(0, 2, 1)), jnp.asarray(img), down, up,
        P1, P2, adaptive, jnp.int16, None)
    vert = down + up
    got = agg.sgm_sweep_family(torch.from_numpy(cost),
                               _tables(img, vert, adaptive), vert, P1,
                               s_dtype=agg.plan_dtypes(s_max))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).transpose(0, 2, 1))


def test_down_family_added_into_s():
    """#14: the dy = 1 family of the 16-path set, adaptive P2, added into
    an existing int16 S, equals that S plus the sum of aggregate_one_path
    over the family."""
    img, cost = _volume(23, 41, 16, seed=3)
    family = [r for r in DIRS_16 if r[0] == 1]
    rng = np.random.default_rng(14)
    s0 = rng.integers(0, 2000, cost.shape).astype(np.int16)
    want = s0.astype(np.int64)
    for r in family:
        want += np.asarray(jagg.aggregate_one_path(
            jnp.asarray(cost), jnp.asarray(img), r, P1, P2, True))
    s = torch.from_numpy(s0.copy())
    got = agg.sgm_sweep_family(torch.from_numpy(cost),
                               _tables(img, family, True), family, P1, s=s)
    assert got is s
    np.testing.assert_array_equal(s.numpy(), want)


def test_2d_rule_with_pad_slots():
    """Flow's (5 x 5) label grid, 25 labels in 32 slots whose pads cost 0:
    both groups of the 8 paths, into an int32 S, equal the sum of
    aggregate_one_path with the 2D neighbour rule; the pads stay 0."""
    radius, e, nl, nd = 2, 5, 25, 32
    h, w = 11, 17
    rng = np.random.default_rng(5)
    cost = rng.integers(0, 25, (h, w, nl)).astype(np.uint8)
    img = rng.integers(0, 256, (h, w)).astype(np.uint8)
    padded = np.concatenate([cost, np.zeros((h, w, nd - nl), np.uint8)], -1)
    want = sum(np.asarray(jagg.aggregate_one_path(
        jnp.asarray(cost), jnp.asarray(img), r, P1, P2, True,
        jagg.make_neighbor_min_2d(radius))).astype(np.int64) for r in DIRS_8)
    s = None
    for group in agg.direction_groups(DIRS_8):
        s = agg.sgm_sweep_family(torch.from_numpy(padded),
                                 _tables(img, group, True), group, P1, s=s,
                                 s_dtype=torch.int32, label_ext=e, nl=nl)
    assert s.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy()[..., :nl], want)
    assert not s[..., nl:].any()


def test_rejects_a_carry_and_bad_input():
    img, cost = _volume(9, 20, 16, seed=1)
    tc = torch.from_numpy(cost)
    dirs = [(1, 0), (-1, 1)]
    tables = _tables(img, dirs, False)
    carry = torch.zeros((2,) + tc.shape[1:], dtype=torch.int32)
    with pytest.raises(TypeError, match="init_carry"):
        agg.sgm_sweep_family(tc, tables, dirs, P1, init_carry=carry)
    with pytest.raises(TypeError, match="return_carry"):
        agg.sgm_sweep_family(tc, tables, dirs, P1, return_carry=True)
    with pytest.raises(ValueError):
        agg.sgm_sweep_family(tc, tables[:0], [], P1)
    with pytest.raises(ValueError):
        agg.sgm_sweep_family(tc, tables, [(1, 0), (0, 0)], P1)
    with pytest.raises(TypeError):
        agg.sgm_sweep_family(tc, tables[:1], dirs, P1)
    with pytest.raises(ValueError):
        agg.sgm_sweep_family(tc, tables, dirs, P1,
                             s=torch.zeros((9, 20, 8), dtype=torch.int16))


@pytest.fixture
def fused(monkeypatch):
    """aggregate_paths takes the family launches on the CPU too."""
    monkeypatch.setattr(agg, "family_launch_pays", lambda *a, **k: True)


def _per_direction(tc, ti, dirs, s_max, e=None, nl=None):
    s = None
    for r in dirs:
        s = agg.sgm_sweep(tc, agg.p2_effective(ti, r, P1, P2, True), r, P1,
                          s=s, s_dtype=agg.plan_dtypes(s_max), label_ext=e,
                          nl=nl)
    return s


def test_fused_aggregate_paths_equals_per_direction(fused):
    """aggregate_paths in family launches equals the per-direction sweeps
    and its plain version for 8 and 16 paths and a one-group set, int16
    and int32 S; the groups are the dy != 0 and the dy = 0 directions."""
    img, cost = _volume(19, 30, 16, seed=2)
    ti, tc = torch.from_numpy(img), torch.from_numpy(cost)
    assert agg.direction_groups(DIRS_8) == [
        [r for r in DIRS_8 if r[0] != 0], [(0, 1), (0, -1)]]
    assert agg.direction_groups(DIRS_8[:4]) == [[(1, 0), (-1, 0)],
                                                [(0, 1), (0, -1)]]
    assert agg.direction_groups(DIRS_8[:2]) == [[(0, 1), (0, -1)]]
    for dirs, s_max in ((DIRS_8, 2841), (DIRS_16, 40000),
                        ([(1, 0), (-1, 1)], 900), (DIRS_8[:2], 900)):
        want = _per_direction(tc, ti, dirs, s_max)
        for fn in (agg.aggregate_paths, agg.aggregate_paths_plain):
            got = fn(tc, ti, dirs, P1, P2, True, s_max)
            assert got.dtype == want.dtype and torch.equal(got, want), dirs


def test_fused_stereo_and_flow_equal_default(monkeypatch):
    """stereo_sgm (16 paths, adaptive) and flow_fsgm with every K2 call in
    family launches equal their per-direction results bit for bit at
    37x53."""
    il, ir, _ = random_dot_stereo(37, 53, 32, seed=5)
    tl, tr = torch.from_numpy(il), torch.from_numpy(ir)
    p = SGMParams(max_disp=32, p1=7, p2=60, adaptive_p2=True, num_paths=16)
    i1, i2, _, _ = blockwise_flow_pair(37, 53, 4, seed=0)
    f1, f2 = torch.from_numpy(i1), torch.from_numpy(i2)
    fp = FlowParams(search_radius=2, levels=2, adaptive_p2=True)
    want_s, want_f = stereo_sgm(tl, tr, p), flow_fsgm(f1, f2, fp)
    calls = []
    family = agg.sgm_sweep_family
    monkeypatch.setattr(agg, "family_launch_pays", lambda *a, **k: True)
    monkeypatch.setattr(agg, "sgm_sweep_family",
                        lambda *a, **k: calls.append(a[2]) or family(*a, **k))
    assert torch.equal(stereo_sgm(tl, tr, p), want_s)
    assert calls == agg.direction_groups(p.dirs)
    got = flow_fsgm(f1, f2, fp)
    assert all(torch.equal(a, b) for a, b in zip(got, want_f))
    assert len(calls) > 2


def test_family_launch_rule():
    """lines_per_frame counts the pixels whose predecessor lies outside the
    frame.  family_launch_pays takes a group's family launch while frames x
    its most lines x K^1.5 stays below FAMILY_SHARE x its directions x the
    resident warps: with the per-direction kernel's resident warps on one
    H100 (4,224 at D=128, 5,280 at D=64, chip_smoke.py), one KITTI frame
    sweeps its vertical group per direction and its horizontal pair in one
    family launch, two frames everything per direction; config 1 (288x384,
    D=64) takes family launches for both groups up to 4 frames and none
    from 8.  Off the card (0 warps) it never pays, so launch_plan sweeps
    per direction on the CPU."""
    for h, w in ((375, 1242), (5, 3), (1, 7), (2, 2)):
        ys, xs = np.mgrid[:h, :w]
        for dy, dx in DIRS_16:
            outside = ((ys - dy < 0) | (ys - dy >= h) | (xs - dx < 0)
                       | (xs - dx >= w))
            assert agg.lines_per_frame(h, w, (dy, dx)) == outside.sum()
    assert agg.lines_per_frame(375, 1242, (1, 1)) == 1616
    vert, horiz = agg.direction_groups(DIRS_8)

    def pays(frames, h, w, group, nd):
        return agg.family_launch_pays(frames, h, w, group, nd,
                                      {128: 4224, 64: 5280}[nd])

    assert not pays(1, 375, 1242, vert, 128) and pays(1, 375, 1242, horiz, 128)
    assert not pays(2, 375, 1242, horiz, 128)
    for group in (vert, horiz):
        assert [pays(b, 288, 384, group, 64) for b in (1, 2, 4, 8, 16)] == \
            [True] * 3 + [False] * 2
    assert not agg.family_launch_pays(1, 37, 53, vert, 32, 0)
    assert agg.resident_warps(torch.device("cpu"), 128, torch.int16) == 0
    assert agg.launch_plan((37, 53, 32), torch.device("cpu"), DIRS_16, 7,
                           60) == [(g, False) for g in
                                   agg.direction_groups(DIRS_16)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_family_kernel_matches_plain_on_the_card(card):
    """The family launch against its plain version: 1D labels with D = 32
    (one label per lane: the single-value int16 atomics) and D = 64 (paired
    int16 atomics), the 2D rule with 81 labels in 96 slots (three labels per
    lane), two frames, fresh S and S given, int16 and int32; and
    aggregate_paths (family launches at this size) equal to the
    per-direction launches."""
    rng = np.random.default_rng(0)
    for nd, nl, e, dirs in ((32, 32, None, DIRS_16), (64, 64, None, DIRS_8),
                            (96, 81, 9, DIRS_8)):
        b, h, w = 2, 13, 29
        cost = torch.from_numpy(rng.integers(0, 26, (b, h, w, nd))
                                .astype(np.uint8)).to(card)
        img = torch.from_numpy(rng.integers(0, 256, (b, h, w))
                               .astype(np.uint8)).to(card)
        for group in agg.direction_groups(dirs):
            tables = torch.stack([agg.p2_effective(img, r, P1, P2, True)
                                  for r in group])
            want = agg.sgm_sweep_family_plain(cost, tables, group, P1, e, nl)
            for dtype in (torch.int16, torch.int32):
                got = agg.sgm_sweep_family(cost, tables, group, P1,
                                           s_dtype=dtype, label_ext=e, nl=nl)
                assert torch.equal(got, want.to(dtype)), (nd, group, dtype)
                s0 = torch.randint(0, 500, cost.shape, dtype=dtype,
                                   device=card)
                got = agg.sgm_sweep_family(cost, tables, group, P1,
                                           s=s0.clone(), label_ext=e, nl=nl)
                assert torch.equal(got, s0 + want.to(dtype)), (nd, group)
        plan = agg.launch_plan(cost.shape, card, dirs, P1, P2, 2841, e)
        assert plan == [(g, True) for g in agg.direction_groups(dirs)]
        assert torch.equal(agg.aggregate_paths(cost, img, dirs, P1, P2,
                                               True, 2841, e, nl),
                           _per_direction(cost, img, dirs, 2841, e, nl))
