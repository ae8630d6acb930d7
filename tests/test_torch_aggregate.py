"""PyTorch port: K2 SGM path aggregation (plain version on the CPU).

Held against the TPU kernel it replaces, fsgm_tpu/ops/pallas/aggregate_tr.py
(interpret mode, as the JAX package's own tests run it), and against
golden/sgm.py, exactly: each of the 8 directions alone, the full 8-path set
with adaptive P2 off and on, and one odd shape.  The plain sweep is also
held to golden for the knight directions of the 16-path set, and the P2'
table and the S dtype plan to the JAX package's.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.sgm as g
from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu.ops.pallas import aggregate_tr as ptr
from fsgm_tpu.ops.pallas import aggregate_pallas as pap
from fsgm_tpu_torch.params import DIRS_8, DIRS_16
from fsgm_tpu_torch.ops.kernels import aggregate as agg

P1, P2 = 7, 60


def _volume(h, w, d, seed):
    img_l, img_r, _ = random_dot_stereo(h, w, d, seed=seed)
    cost = g.cost_volume_stereo(g.census_transform(img_l),
                                g.census_transform(img_r), d, 255)
    return img_l, cost


@pytest.fixture(scope="module")
def volume():
    return _volume(40, 56, 16, seed=7)


@pytest.fixture(scope="module")
def jax_s():
    """aggregate_paths_tr outputs, computed once per (dirs, adaptive)."""
    cache = {}

    def get(img, cost, dirs, adaptive, s_max=None):
        key = (img.shape, tuple(dirs), adaptive, s_max)
        if key not in cache:
            cost_hlw = jnp.asarray(cost.transpose(0, 2, 1), dtype=jnp.uint8)
            cache[key] = np.asarray(ptr.aggregate_paths_tr(
                cost_hlw, jnp.asarray(img), list(dirs), P1, P2, adaptive,
                s_max=s_max))
        return cache[key]
    return get


def _port_sweep(img, cost, r, adaptive):
    tc, ti = torch.from_numpy(cost.astype(np.uint8)), torch.from_numpy(img)
    p2e = agg.p2_effective(ti, r, P1, P2, adaptive)
    return agg.sgm_sweep(tc, p2e, r, P1, s_dtype=torch.int32).numpy()


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("r", DIRS_8)
def test_each_direction_matches_tr_family_sweep(volume, jax_s, r, adaptive):
    img, cost = volume
    ours = _port_sweep(img, cost, r, adaptive)
    np.testing.assert_array_equal(ours, jax_s(img, cost, [r], adaptive))
    np.testing.assert_array_equal(
        ours, g.aggregate_one_path(cost, img, r, P1, P2, adaptive))


@pytest.mark.parametrize("r", DIRS_16[8:])
@pytest.mark.parametrize("adaptive", [False, True])
def test_knight_directions_match_golden(volume, r, adaptive):
    img, cost = volume
    np.testing.assert_array_equal(
        _port_sweep(img, cost, r, adaptive),
        g.aggregate_one_path(cost, img, r, P1, P2, adaptive))


def _port_s(img, cost, dirs, adaptive, s_max):
    return agg.aggregate_paths(torch.from_numpy(cost.astype(np.uint8)),
                               torch.from_numpy(img), dirs, P1, P2,
                               adaptive, s_max=s_max)


@pytest.mark.parametrize("adaptive", [False, True])
def test_full_set_matches_aggregate_paths_tr(volume, jax_s, adaptive):
    img, cost = volume
    s_max = len(DIRS_8) * (255 + P2)
    ours = _port_s(img, cost, DIRS_8, adaptive, s_max)
    assert ours.dtype == torch.int16
    want = jax_s(img, cost, DIRS_8, adaptive, s_max)
    assert want.dtype == np.int16
    np.testing.assert_array_equal(ours.numpy(), want)
    gold = sum(g.aggregate_one_path(cost, img, r, P1, P2, adaptive)
               for r in DIRS_8)
    np.testing.assert_array_equal(ours.numpy(), gold)


def test_odd_shape_matches_tr_and_golden(jax_s):
    img, cost = _volume(37, 53, 16, seed=37 * 53)
    ours = _port_s(img, cost, DIRS_8, True, None).numpy()
    np.testing.assert_array_equal(ours, jax_s(img, cost, DIRS_8, True))
    gold = sum(g.aggregate_one_path(cost, img, r, P1, P2, True)
               for r in DIRS_8)
    np.testing.assert_array_equal(ours, gold)


@pytest.mark.parametrize("r", [(1, 0), (-1, 1), (0, -1), (2, -1)])
def test_p2_effective_matches_jax(volume, r):
    """Equal wherever the predecessor p - r is inside the image (the only
    pixels whose P2' the recurrence reads)."""
    img = volume[0]
    h, w = img.shape
    ours = agg.p2_effective(torch.from_numpy(img), r, P1, 100, True).numpy()
    want = np.asarray(pap._p2_effective(jnp.asarray(img), r[0], r[1], P1,
                                        100, True))
    ys, xs = np.mgrid[0:h, 0:w]
    inside = ((ys - r[0] >= 0) & (ys - r[0] < h)
              & (xs - r[1] >= 0) & (xs - r[1] < w))
    np.testing.assert_array_equal(ours[inside], want[inside])
    flat = agg.p2_effective(torch.from_numpy(img), r, P1, 100, False)
    assert flat.dtype == torch.int32 and bool((flat == 100).all())


@pytest.mark.parametrize("s_max", [None, 2841, (1 << 15) - 1, 1 << 15])
def test_plan_dtypes_matches_jax(s_max):
    want = pap.plan_dtypes(100, s_max)[0]
    assert agg.plan_dtypes(s_max) == {jnp.int16: torch.int16,
                                      jnp.int32: torch.int32}[want]


def test_sweep_adds_into_s_in_place(volume):
    img, cost = volume
    tc, ti = torch.from_numpy(cost.astype(np.uint8)), torch.from_numpy(img)
    p2e = agg.p2_effective(ti, (1, 1), P1, P2, False)
    s = agg.sgm_sweep(tc, p2e, (0, 1), P1, s_dtype=torch.int16)
    again = agg.sgm_sweep(tc, p2e, (1, 1), P1, s=s)
    assert again is s and s.dtype == torch.int16
    gold = (g.aggregate_one_path(cost, img, (0, 1), P1, P2)
            + g.aggregate_one_path(cost, img, (1, 1), P1, P2))
    np.testing.assert_array_equal(s.numpy(), gold)


@pytest.mark.parametrize("bad", ["direction", "cost_dtype", "p2e_shape",
                                 "s_shape"])
def test_sweep_rejects_bad_input(volume, bad):
    img, cost = volume
    tc = torch.from_numpy(cost.astype(np.uint8))
    p2e = torch.full(img.shape, P2, dtype=torch.int32)
    kw = dict(cost=tc, p2e=p2e, direction=(0, 1), p1=P1)
    if bad == "direction":
        kw["direction"] = (0, 3)
    elif bad == "cost_dtype":
        kw["cost"] = tc.to(torch.int32)
    elif bad == "p2e_shape":
        kw["p2e"] = p2e[:-1]
    else:
        kw["s"] = torch.zeros((2, 2, 2), dtype=torch.int16)
    with pytest.raises((TypeError, ValueError)):
        agg.sgm_sweep(**kw)
