"""PyTorch port: the edges of a tile (plain versions on the CPU).

K2's carry on a one-row tile (knights read carry row 1; carry-out row 1 is
carry-in row 0) against fsgm_tpu/ops/aggregate.py::aggregate_one_path, and
two sweeps split at a seam equal to one sweep of the whole image, frame by
frame.  K3's window columns: the right-view WTA and the LR check of a
window in global columns are held against the JAX package's
wta_right_from_s(gx, w_global) and lr_check on the masked right view.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.sgm as g
from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu.ops import aggregate as jagg
from fsgm_tpu.ops import extract as jext
from fsgm_tpu_torch.params import DIRS_16
from fsgm_tpu_torch.ops import extract as ext
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


def _jax_sweep(cost, img, r, above2, below2, carry):
    """aggregate_one_path with the canonical-frame halo of the direction's
    family (the JAX tiled path's _XlaFamilyBackend._prev2)."""
    prev2 = above2 if r[0] > 0 else below2[::-1]
    l, cout = jagg.aggregate_one_path(
        jnp.asarray(cost), jnp.asarray(img), r, P1, P2, True,
        jagg.neighbor_min_1d, init_carry=jnp.asarray(carry),
        img_prev2=jnp.asarray(prev2), return_carry=True)
    return np.asarray(l).astype(np.int32), np.asarray(cout)


@pytest.mark.parametrize("r", [(1, 0), (-1, 1), (2, -1), (-2, 1)])
def test_one_row_tile(volume, r):
    """H = 1: the one row runs from the carry (knights from its row 1), and
    carry-out row 1 is carry-in row 0, or zeros without a carry."""
    img, cost = volume
    w, d = cost.shape[1:]
    rng = np.random.default_rng(11)
    carry = rng.integers(0, CMAX + P2 + 1, (2, w, d)).astype(np.int32)
    above2, below2 = _halos(rng, w)
    row_img, row_cost = img[4:5], cost[4:5]
    p2e = agg.p2_effective(torch.from_numpy(row_img), r, P1, P2, True,
                           torch.from_numpy(above2), torch.from_numpy(below2))
    l, cout = agg.sgm_sweep_plain(torch.from_numpy(row_cost), p2e, r, P1,
                                  init_carry=torch.from_numpy(carry),
                                  return_carry=True)
    want_l, want_c = _jax_sweep(row_cost, row_img, r, above2, below2, carry)
    np.testing.assert_array_equal(l.numpy(), want_l)
    np.testing.assert_array_equal(cout.numpy(), want_c)
    assert torch.equal(cout[1], torch.from_numpy(carry[0]))
    _, fresh = agg.sgm_sweep_plain(torch.from_numpy(row_cost), p2e, r, P1,
                                   return_carry=True)
    assert torch.equal(fresh[0], torch.from_numpy(row_cost[0]).to(torch.int32))
    assert not fresh[1].any()


@pytest.mark.parametrize("seam", [1, 2, 7])
def test_two_sweeps_split_at_a_seam_equal_one(seam):
    """Every vertical direction of the 16-path set over two frames of
    different content: the tile above the seam, then the tile below from
    its carry (down), or the other way round (up), equals the whole sweep
    of each frame."""
    frames = [_volume(12, 20, 16, seed=s) for s in (1, 2)]
    img = torch.from_numpy(np.stack([f[0] for f in frames]))
    cost = torch.from_numpy(np.stack([f[1] for f in frames]))
    top, bottom = slice(0, seam), slice(seam, None)
    # the rows [seam-2, seam) above the seam (row -1, never read, clamped)
    above2 = img[:, [max(seam - 2, 0), seam - 1]]
    for r in [q for q in DIRS_16 if q[0] != 0]:
        whole = agg.sgm_sweep_plain(
            cost, agg.p2_effective(img, r, P1, P2, True), r, P1)

        def part(rows, carry):
            p2e = agg.p2_effective(img[:, rows], r, P1, P2, True, above2,
                                   img[:, seam:seam + 2])
            return agg.sgm_sweep_plain(cost[:, rows].contiguous(), p2e, r,
                                       P1, init_carry=carry,
                                       return_carry=True)
        if r[0] > 0:
            l_top, carry = part(top, None)
            l_bottom, _ = part(bottom, carry)
        else:
            l_bottom, carry = part(bottom, None)
            l_top, _ = part(top, carry)
        assert torch.equal(torch.cat([l_top, l_bottom], 1), whole), r


@pytest.mark.parametrize("gx0,w_global", [(-9, 30), (5, 20), (-4, 12)])
def test_window_validity_matches_jax(gx0, w_global):
    """wta_right_from_s with a window's global columns equals the JAX
    package's; the LR check with x_lo equals lr_check on the right view
    masked outside the image, on every column left of the global right
    edge (the columns a tile keeps, and those the median's edge fill
    overwrites on the left)."""
    rng = np.random.default_rng(gx0 + 50)
    h, w, d, s_invalid = 6, 24, 16, 900
    s = rng.integers(0, 60, (h, w, d)).astype(np.int16)
    gx = gx0 + np.arange(w, dtype=np.int32)
    want_r = np.asarray(jext.wta_right_from_s(
        jnp.asarray(s), s_invalid, gx=jnp.asarray(gx), w_global=w_global))
    got_r = ext.wta_right_from_s(torch.from_numpy(s), s_invalid, gx0,
                                 w_global)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    disp = (ext.wta(torch.from_numpy(s)).to(torch.float32)
            + torch.from_numpy(rng.uniform(-0.6, 0.6, (h, w))
                               .astype(np.float32)))
    in_img = (gx >= 0) & (gx < w_global)
    masked = np.where(in_img[None, :], want_r, -(1 << 20))
    want = np.asarray(jext.lr_check(jnp.asarray(disp.numpy()),
                                    jnp.asarray(masked), 1, d))
    got = ext.lr_check(disp, got_r, 1, d, x_lo=max(0, -gx0)).numpy()
    keep = gx < w_global
    np.testing.assert_array_equal(got[:, keep], want[:, keep])
    # K3's plain version: the same rules in one pass
    planes = kext.extract_stereo(torch.from_numpy(s), s_invalid, 1, True,
                                 gx0=gx0, w_global=w_global)
    sub = ext.subpixel_from_neighborhood(*planes[:4], d)
    want_v = ext.lr_valid(sub, ext.wta_right_from_s(
        torch.from_numpy(s), s_invalid, gx0, w_global), 1, d,
        x_lo=max(0, -gx0))
    assert torch.equal(planes[4], want_v.to(torch.int32))
    assert torch.equal(kext.extract_stereo(torch.from_numpy(s), s_invalid)[4],
                       kext.extract_stereo(torch.from_numpy(s), s_invalid,
                                           gx0=0, w_global=w)[4])
