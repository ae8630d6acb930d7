"""PyTorch port: K2 (csrc/sgm_sweep.cu) against its plain version on the
card, at the cases its ring and its packed 16-bit labels make hard.

Every test here needs an NVIDIA card (the kernel has no CPU mode) and skips
without one; tests/test_torch_k2_plan.py holds the host-side logic on the
CPU.  Each case compares sgm_sweep (fresh S and S given, with and without
carry) or sgm_sweep_family with sgm_sweep_plain / sgm_sweep_family_plain on
the same inputs, bit for bit, in both of K2's arithmetic forms where the
case allows the packed one (packed16): once with the bound p2_max that
permits it and once without a bound (int32 labels).
"""

import numpy as np
import pytest
import torch

from fsgm_tpu_torch import DIRS_8, DIRS_16
from fsgm_tpu_torch.ops.kernels import _build
from fsgm_tpu_torch.ops.kernels import aggregate as agg

P1, P2 = 7, 60


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, shape, cmax=26, seed=0, p1=P1, p2=P2, dirs=DIRS_8,
            adaptive=True):
    rng = np.random.default_rng(seed)
    cost = torch.from_numpy(rng.integers(0, cmax, shape).astype(np.uint8))
    img = torch.from_numpy(rng.integers(0, 256, shape[:-1]).astype(np.uint8))
    cost, img = cost.to(dev), img.to(dev)
    return cost, {r: agg.p2_effective(img, r, p1, p2, adaptive)
                  for r in dirs}


def _check_sweeps(cost, tables, p1, s_dtype, label_ext=None, nl=None,
                  p2_max=None, carry=False, seed=1):
    """Each direction, fresh and into a given S (and with carry in and out
    for dy != 0), with p2_max and without, equal to the plain sweep."""
    g = torch.Generator(device=cost.device).manual_seed(seed)
    b_shape = cost.shape[:-3]
    for r, p2e in tables.items():
        cin = None
        if carry and r[0] != 0:
            cin = torch.randint(0, 300, b_shape + (2,) + cost.shape[-2:],
                                generator=g, device=cost.device,
                                dtype=torch.int32)
        ret = cin is not None
        want = agg.sgm_sweep_plain(cost, p2e, r, p1, label_ext, nl, cin,
                                   return_carry=ret)
        want_l, want_c = want if ret else (want, None)
        s0 = torch.randint(0, 500, cost.shape, generator=g,
                           device=cost.device).to(s_dtype)
        for bound in {p2_max, None}:
            for given in (False, True):
                got = agg.sgm_sweep(cost, p2e, r, p1,
                                    s=s0.clone() if given else None,
                                    s_dtype=s_dtype, label_ext=label_ext,
                                    nl=nl, init_carry=cin,
                                    return_carry=ret, p2_max=bound)
                got_s, got_c = got if ret else (got, None)
                want_s = ((s0.to(torch.int32) + want_l) if given
                          else want_l).to(s_dtype)
                tag = (tuple(cost.shape), r, s_dtype, bound, given)
                assert torch.equal(got_s, want_s), tag
                assert not ret or torch.equal(got_c, want_c), tag


@pytest.mark.cuda
def test_lines_shorter_than_the_ring(card):
    """H = 1, W = 1, 2x2 and knights on 3 rows: every line is shorter than
    the 16-step ring; D = 128, int16 S (packed and int32 labels) and int32
    S."""
    for shape, dirs in (((2, 1, 40, 128), DIRS_8), ((2, 40, 1, 128), DIRS_8),
                        ((1, 2, 2, 128), DIRS_16), ((2, 3, 29, 128), DIRS_16)):
        cost, tables = _inputs(card, shape, dirs=dirs)
        for s_dtype in (torch.int16, torch.int32):
            _check_sweeps(cost, tables, P1, s_dtype,
                          p2_max=agg.p2_bound(P1, P2), carry=True)


@pytest.mark.cuda
def test_every_label_width(card):
    """D = 32, 64, 128 and 256 with 1D labels (pad slots past nl) and D =
    96 with 81 labels on the 2D rule, D = 64 with 49; int16 and int32 S,
    two frames."""
    for nd, nl, e in ((32, 32, None), (64, 60, None), (128, 128, None),
                      (256, 250, None), (96, 81, 9), (64, 49, 7)):
        cost, tables = _inputs(card, (2, 11, 23, nd), seed=nd)
        for s_dtype in (torch.int16, torch.int32):
            _check_sweeps(cost, tables, P1, s_dtype, e, nl,
                          p2_max=agg.p2_bound(P1, P2))


@pytest.mark.cuda
def test_packed_predicate_edge(card):
    """Costs of 255 and P2' = PACKED_P2_MAX everywhere, the largest bound
    for which packed16 holds, with P1 = 0 and P1 = PACKED_P1_MAX, into
    int16 S; and p2 = 7000 into int32 S."""
    p2 = agg.PACKED_P2_MAX
    for p1 in (0, agg.PACKED_P1_MAX):
        cost, tables = _inputs(card, (1, 9, 31, 64), cmax=256, p1=p1, p2=p2,
                               adaptive=False)
        assert agg.packed16(torch.int16, 64, p1, p2)
        assert not agg.packed16(torch.int16, 64, p1, p2 + 1)
        assert not agg.packed16(torch.int16, 64, agg.PACKED_P1_MAX + 1, p2)
        _check_sweeps(cost, tables, p1, torch.int16, p2_max=p2, carry=True)
    cost, tables = _inputs(card, (1, 9, 31, 64), p2=7000)
    _check_sweeps(cost, tables, P1, torch.int32, p2_max=agg.p2_bound(P1, 7000))


@pytest.mark.cuda
def test_carry_on_one_and_two_row_tiles(card):
    """Tiles of 1 and 2 rows continue from a carry and export theirs, 1D
    (16 paths, knights) and 2D (25 labels in 32 slots, 49 in 64)."""
    for rows in (1, 2):
        cost, tables = _inputs(card, (2, rows, 37, 128), dirs=DIRS_16)
        _check_sweeps(cost, tables, P1, torch.int16,
                      p2_max=agg.p2_bound(P1, P2), carry=True)
        for nd, e in ((32, 5), (64, 7)):
            cost, tables = _inputs(card, (2, rows, 19, nd))
            _check_sweeps(cost, tables, P1, torch.int16, e, e * e,
                          p2_max=agg.p2_bound(P1, P2), carry=True)


@pytest.mark.cuda
def test_family_launch_fresh_and_given(card):
    """The family launch over both direction groups, fresh S and S given,
    packed and int32 labels, 1D at D = 64 and 128 and 2D at D = 96, and
    the LAUNCHES count of one launch."""
    for nd, nl, e in ((64, 64, None), (128, 125, None), (96, 81, 9)):
        cost, tables = _inputs(card, (2, 13, 29, nd), seed=nd)
        for group in agg.direction_groups(DIRS_8):
            t = torch.stack([tables[r] for r in group])
            want = agg.sgm_sweep_family_plain(cost, t, group, P1, e, nl)
            for bound in (agg.p2_bound(P1, P2), None):
                got = agg.sgm_sweep_family(cost, t, group, P1, label_ext=e,
                                           nl=nl, p2_max=bound)
                assert torch.equal(got, want.to(torch.int16)), (nd, group)
                s0 = torch.randint(0, 500, cost.shape, device=card,
                                   dtype=torch.int16)
                got = agg.sgm_sweep_family(cost, t, group, P1, s=s0.clone(),
                                           label_ext=e, nl=nl, p2_max=bound)
                assert torch.equal(got, s0 + want.to(torch.int16)), nd
    _build.LAUNCHES.clear()
    agg.sgm_sweep_family(cost, t, group, P1, label_ext=e, nl=nl)
    assert _build.LAUNCHES == {"sgm_sweep_family": 1}
