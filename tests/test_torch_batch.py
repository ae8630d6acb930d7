"""PyTorch port: the batched stereo path (K1, K2 and K3 over B frames).

  * stereo_sgm_batch against JAX stereo_sgm_batch(..., "pallas_tr"), 8
    paths and 16 paths with adaptive P2: invalid masks identical,
    disparities within 1e-3, and each frame bit for bit stereo_sgm alone;
  * frame bleed: frames of different content, one whose last row is bright
    and the next one's first row dark; census, P2', each sweep direction,
    the extraction, the median and the whole pipeline over the batch equal
    the same on each frame alone, bit for bit;
  * the kernels' (H, W, ...) calls equal their (1, H, W, ...) calls.
K1's batched build is held to the JAX package in test_torch_census_cost.py.
The CUDA kernels themselves are held to these plain versions on the card by
the `cuda`-marked test here and by chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu.models.stereo import stereo_sgm_batch as jax_stereo_sgm_batch
from fsgm_tpu_torch import (DIRS_16, SGMParams, stereo_sgm, stereo_sgm_batch,
                            stereo_sgm_batch_reference)
from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.kernels import _build, aggregate, cost, extract

H, W, D, B = 37, 53, 16, 3
TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pairs(b=B, h=H, w=W, d=D):
    pairs = [random_dot_stereo(h, w, d, seed=10 + s) for s in range(b)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def _bleed_pairs(d=D):
    """Frames of different content; frame 0's last row bright, frame 1's
    first row dark, in both views."""
    il, ir = _pairs(d=d)
    il[0, -1], ir[0, -1] = 255, 255
    il[1, 0], ir[1, 0] = 0, 0
    return il, ir


@pytest.mark.parametrize("num_paths,adaptive", [(8, False), (16, True)])
def test_batch_matches_jax_stereo_sgm_batch(num_paths, adaptive):
    p = SGMParams(max_disp=D, p1=7, p2=60, num_paths=num_paths,
                  adaptive_p2=adaptive)
    il, ir = _pairs()
    want = np.asarray(jax_stereo_sgm_batch(jnp.asarray(il), jnp.asarray(ir),
                                           p, "pallas_tr"))
    ours = stereo_sgm_batch(_t(il), _t(ir), p).numpy()
    assert ours.shape == (B, H, W) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours < 0, want < 0)
    both = ours >= 0
    np.testing.assert_allclose(ours[both], want[both], atol=TOL)
    for k in range(B):
        np.testing.assert_array_equal(
            ours[k], stereo_sgm(_t(il[k]), _t(ir[k]), p).numpy())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_paths=16, adaptive_p2=True, lr_mode="reagg", fill_invalid=True),
])
def test_frame_bleed_batch_equals_per_frame(kw):
    p = SGMParams(max_disp=D, p1=7, p2=60, **kw)
    il, ir = _bleed_pairs()
    tl, tr = _t(il), _t(ir)
    batch = stereo_sgm_batch(tl, tr, p)
    for k in range(B):
        np.testing.assert_array_equal(batch[k].numpy(),
                                      stereo_sgm(tl[k], tr[k], p).numpy())


def test_frame_bleed_stage_by_stage():
    """Each stage over the batch equals the stage on each frame alone."""
    il, ir = _bleed_pairs()
    tl, tr = _t(il), _t(ir)
    cl, cr = census_transform(tl), census_transform(tr)
    c = cost.census_cost(cl, cr, D)
    s_dtype = aggregate.plan_dtypes(5000)
    for k in range(B):
        np.testing.assert_array_equal(cl[k], census_transform(tl[k]))
        np.testing.assert_array_equal(
            c[k], cost.census_cost(cl[k], cr[k], D))
    for r in DIRS_16:
        p2e = aggregate.p2_effective(tl, r, 7, 60, True)
        l_r = aggregate.sgm_sweep(c, p2e, r, 7, s_dtype=s_dtype)
        for k in range(B):
            p2k = aggregate.p2_effective(tl[k], r, 7, 60, True)
            np.testing.assert_array_equal(p2e[k], p2k)
            np.testing.assert_array_equal(
                l_r[k], aggregate.sgm_sweep(c[k], p2k, r, 7,
                                            s_dtype=s_dtype))
    s = aggregate.aggregate_paths(c, tl, DIRS_16, 7, 60, True, 5000)
    for with_rwta in (True, False):
        outs = extract.extract_stereo(s, 5000, 1, True, with_rwta)
        assert (outs[4] is None) == (not with_rwta)
        for k in range(B):
            alone = extract.extract_stereo(s[k], 5000, 1, True, with_rwta)
            for a, b in zip(outs, alone):
                if a is not None:
                    np.testing.assert_array_equal(a[k], b)
    field = torch.where(s[..., 0] > s[..., 1], -1.0, s[..., 2].float())
    med = ext.median_filter_3x3(field)
    fill = ext.interpolate_invalid(field)
    for k in range(B):
        np.testing.assert_array_equal(med[k], ext.median_filter_3x3(field[k]))
        np.testing.assert_array_equal(fill[k],
                                      ext.interpolate_invalid(field[k]))


def test_without_rwta_k3_returns_the_same_planes_and_no_validity():
    il, ir = _pairs(b=2)
    p = SGMParams(max_disp=D, p1=7, p2=60)
    c = cost.census_cost(census_transform(_t(il)), census_transform(_t(ir)),
                         D)
    s = aggregate.aggregate_paths(c, _t(il), p.dirs, p.p1, p.p2,
                                  s_max=p.s_invalid)
    full = extract.extract_stereo_plain(s, p.s_invalid, 1, True)
    bare = extract.extract_stereo_plain(s, p.s_invalid, 1, True, False)
    assert bare[4] is None and full[4].shape == (2, H, W)
    for a, b in zip(full[:4], bare[:4]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bad", ["cost_rank", "p2e_frames", "s_rank"])
def test_batched_wrappers_refuse_mismatched_shapes(bad):
    c = torch.zeros((2, 4, 6, 32), dtype=torch.uint8)
    p2e = torch.full((2, 4, 6), 60, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        if bad == "cost_rank":
            aggregate.sgm_sweep(c[None], p2e, (0, 1), 7)
        elif bad == "p2e_frames":
            aggregate.sgm_sweep(c, p2e[:1], (0, 1), 7)
        else:
            extract.extract_stereo(torch.zeros((1, 2, 4, 6, 32),
                                               dtype=torch.int16), 10)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_batched_kernels_match_plain_versions_on_the_card(card):
    p = SGMParams(max_disp=32, p1=7, p2=60, num_paths=16, adaptive_p2=True,
                  lr_mode="reagg", fill_invalid=True)
    il, ir = _bleed_pairs(d=32)
    tl, tr = _t(il).to(card), _t(ir).to(card)
    cl, cr = census_transform(tl), census_transform(tr)
    for rr in (False, True):
        _build.LAUNCHES.clear()
        got = cost.census_cost(cl, cr, 32, 255, rr)
        assert _build.LAUNCHES["census_cost"] == 1
        assert torch.equal(got, cost.census_cost_plain(cl, cr, 32, 255, rr))
    c = cost.census_cost(cl, cr, 32)
    for r in p.dirs:
        p2e = aggregate.p2_effective(tl, r, p.p1, p.p2, True)
        assert torch.equal(
            aggregate.sgm_sweep(c, p2e, r, p.p1, s_dtype=torch.int32),
            aggregate.sgm_sweep_plain(c, p2e, r, p.p1))
    s = aggregate.aggregate_paths(c, tl, p.dirs, p.p1, p.p2, True,
                                  p.s_invalid)
    for with_rwta in (True, False):
        got = extract.extract_stereo(s, p.s_invalid, 1, True, with_rwta)
        want = extract.extract_stereo_plain(s, p.s_invalid, 1, True,
                                            with_rwta)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    for q in (p, dataclasses.replace(p, lr_mode="s_trick",
                                     fill_invalid=False)):
        batch = stereo_sgm_batch(tl, tr, q)
        assert torch.equal(batch, torch.stack(
            [stereo_sgm(tl[k], tr[k], q) for k in range(B)]))
        ref = stereo_sgm_batch_reference(tl, tr, q)
        assert torch.equal(batch < 0, ref < 0)
        assert float((batch - ref)[batch >= 0].abs().max()) <= TOL
