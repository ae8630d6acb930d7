"""PyTorch port: K2's carry across tile seams (plain version on the CPU).

The carry contract is fsgm_tpu/ops/aggregate.py::aggregate_one_path's
(init_carry, img_prev2, return_carry): held against it exactly for the
down, up and knight directions with adaptive P2 and a random carry, and
with the 2D label rule of fSGM flow (pad label slots full of garbage,
which the port must read as INF and write as 0).  One-row tiles, sweeps
split at a seam and K3's window columns are in test_torch_tile_edges.py.
The kernels themselves run on the card (the `cuda` test at the end and
chip_smoke.py phase 8).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.sgm as g
from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu.ops import aggregate as jagg
from fsgm_tpu_torch.params import DIRS_16
from fsgm_tpu_torch.ops.kernels import aggregate as agg
from fsgm_tpu_torch.ops.kernels import extract as kext

P1, P2, CMAX = 7, 60, 24


def _volume(h, w, d, seed):
    img_l, img_r, _ = random_dot_stereo(h, w, d, seed=seed)
    cost = g.cost_volume_stereo(g.census_transform(img_l),
                                g.census_transform(img_r), d, 255)
    return img_l, np.minimum(cost, CMAX).astype(np.uint8)


@pytest.fixture(scope="module")
def volume():
    return _volume(13, 24, 16, seed=5)


def _halos(rng, w):
    return (rng.integers(0, 256, (2, w)).astype(np.uint8),
            rng.integers(0, 256, (2, w)).astype(np.uint8))


def _jax_sweep(cost, img, r, above2, below2, carry, nmin=None):
    """aggregate_one_path with the canonical-frame halo of the direction's
    family (the JAX tiled path's _XlaFamilyBackend._prev2)."""
    prev2 = above2 if r[0] > 0 else below2[::-1]
    l, cout = jagg.aggregate_one_path(
        jnp.asarray(cost), jnp.asarray(img), r, P1, P2, True,
        nmin or jagg.neighbor_min_1d, init_carry=jnp.asarray(carry),
        img_prev2=jnp.asarray(prev2), return_carry=True)
    return np.asarray(l).astype(np.int32), np.asarray(cout)


@pytest.mark.parametrize("r", [(1, 0), (1, 1), (-1, -1), (2, 1), (-2, -1)])
def test_carry_matches_aggregate_one_path(volume, r):
    img, cost = volume
    h, w, d = cost.shape
    rng = np.random.default_rng(abs(r[0]) * 10 + r[1] + 20)
    carry = rng.integers(0, CMAX + P2 + 1, (2, w, d)).astype(np.int32)
    above2, below2 = _halos(rng, w)
    p2e = agg.p2_effective(torch.from_numpy(img), r, P1, P2, True,
                           torch.from_numpy(above2), torch.from_numpy(below2))
    l, cout = agg.sgm_sweep_plain(torch.from_numpy(cost), p2e, r, P1,
                                  init_carry=torch.from_numpy(carry),
                                  return_carry=True)
    want_l, want_c = _jax_sweep(cost, img, r, above2, below2, carry)
    np.testing.assert_array_equal(l.numpy(), want_l)
    np.testing.assert_array_equal(cout.numpy(), want_c)
    # the wrapper (CPU tensors: the plain version) adds L into S
    s = torch.ones(cost.shape, dtype=torch.int16)
    got, c2 = agg.sgm_sweep(torch.from_numpy(cost), p2e, r, P1, s=s,
                            init_carry=torch.from_numpy(carry),
                            return_carry=True)
    assert got is s and torch.equal(c2, cout)
    np.testing.assert_array_equal(s.numpy(), want_l + 1)


@pytest.mark.parametrize("r", [(1, -1), (-2, 1)])
def test_carry_with_2d_labels_and_pad_slots(r):
    """Flow's (e x e) label rule: 25 labels in 32 slots; the carry's pad
    slots hold garbage that must take part in nothing."""
    radius, e, nl, nd = 2, 5, 25, 32
    h, w = 9, 14
    rng = np.random.default_rng(3 + r[1])
    cost = rng.integers(0, CMAX + 1, (h, w, nl)).astype(np.uint8)
    img = rng.integers(0, 256, (h, w)).astype(np.uint8)
    carry = rng.integers(0, CMAX + P2 + 1, (2, w, nl)).astype(np.int32)
    above2, below2 = _halos(rng, w)
    padded = np.concatenate(
        [cost, rng.integers(0, 3, (h, w, nd - nl)).astype(np.uint8)], -1)
    carry_p = np.concatenate(
        [carry, rng.integers(0, 3, (2, w, nd - nl)).astype(np.int32)], -1)
    p2e = agg.p2_effective(torch.from_numpy(img), r, P1, P2, True,
                           torch.from_numpy(above2), torch.from_numpy(below2))
    l, cout = agg.sgm_sweep_plain(torch.from_numpy(padded), p2e, r, P1,
                                  label_ext=e, nl=nl,
                                  init_carry=torch.from_numpy(carry_p),
                                  return_carry=True)
    want_l, want_c = _jax_sweep(cost, img, r, above2, below2, carry,
                                jagg.make_neighbor_min_2d(radius))
    np.testing.assert_array_equal(l.numpy()[..., :nl], want_l)
    np.testing.assert_array_equal(cout.numpy()[..., :nl], want_c)
    assert not l[..., nl:].any() and not cout[..., nl:].any()


def test_carry_rejects_bad_input(volume):
    img, cost = volume
    tc = torch.from_numpy(cost)
    p2e = torch.full(img.shape, P2, dtype=torch.int32)
    with pytest.raises(ValueError):
        agg.sgm_sweep(tc, p2e, (0, 1), P1, return_carry=True)
    with pytest.raises(ValueError):
        agg.sgm_sweep_plain(tc, p2e, (0, -1), P1,
                            init_carry=torch.zeros((2,) + tc.shape[1:],
                                                   dtype=torch.int32))
    with pytest.raises(TypeError):
        agg.sgm_sweep(tc, p2e, (1, 0), P1,
                      init_carry=torch.zeros((2, 3, 16), dtype=torch.int32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_with_carry_and_windows_match_plain_on_the_card(card):
    """K2 with carry (1D and 2D labels, two frames, a 1-row tile) and K3
    with window columns against their plain versions."""
    rng = np.random.default_rng(0)
    for h, nd, nl, e in ((9, 32, 32, None), (1, 32, 32, None),
                         (7, 32, 25, 5)):
        b, w = 2, 21
        cost = torch.from_numpy(rng.integers(0, CMAX + 1, (b, h, w, nd))
                                .astype(np.uint8)).to(card)
        img = torch.from_numpy(rng.integers(0, 256, (b, h, w))
                               .astype(np.uint8)).to(card)
        carry = torch.from_numpy(rng.integers(0, CMAX + P2 + 1, (b, 2, w, nd))
                                 .astype(np.int32)).to(card)
        halos = [torch.from_numpy(rng.integers(0, 256, (b, 2, w))
                                  .astype(np.uint8)).to(card)
                 for _ in range(2)]
        for r in [q for q in DIRS_16 if q[0] != 0]:
            p2e = agg.p2_effective(img, r, P1, P2, True, *halos)
            for cin in (None, carry):
                got = agg.sgm_sweep(cost, p2e, r, P1, s_dtype=torch.int32,
                                    label_ext=e, nl=nl, init_carry=cin,
                                    return_carry=True)
                want = agg.sgm_sweep_plain(cost, p2e, r, P1, e, nl, cin,
                                           return_carry=True)
                assert all(torch.equal(x, y) for x, y in zip(got, want)), r
    s = torch.from_numpy(rng.integers(0, 60, (2, 6, 40, 32))
                         .astype(np.int16)).to(card)
    for gx0, w_global in ((-9, 30), (5, 20), (0, 40), (-50, 200)):
        got = kext.extract_stereo(s, 900, 1, True, gx0=gx0,
                                  w_global=w_global)
        want = kext.extract_stereo_plain(s, 900, 1, True, gx0=gx0,
                                         w_global=w_global)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), gx0
