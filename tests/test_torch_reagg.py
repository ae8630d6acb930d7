"""PyTorch port: lr_mode="reagg", fill_invalid and the ops they add.

  * stereo_sgm with lr_mode="reagg" and fill_invalid=True against JAX
    stereo_sgm(..., "pallas_tr") (interpret mode); each option alone
    against golden/sgm.py::sgm_stereo and the frozen reagg fixture;
    invalid masks identical, disparities within 1e-3;
  * right_disparity_reagg against golden's right-reference SGM and WTA
    (exact integers), interpolate_invalid against fsgm_tpu/ops/extract.py
    and golden (exact), lr_check with max_disp against the JAX rule.
The CLI's options are tested in test_torch_reagg_cli.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.sgm as g
from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu.models import stereo as jstereo
from fsgm_tpu.ops import extract as jext
from fsgm_tpu_torch import SGMParams, stereo_sgm
from fsgm_tpu_torch.models.stereo import right_disparity_reagg
from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.census import census_transform

FIXDIR = Path(__file__).resolve().parents[1] / "tests" / "fixtures"
TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_disp_close(ours, want):
    np.testing.assert_array_equal(ours < 0, want < 0)
    both = ours >= 0
    np.testing.assert_allclose(ours[both], want[both], atol=TOL)


def test_reagg_and_fill_match_jax_pallas_tr():
    il, ir, _ = random_dot_stereo(37, 53, 16, seed=21)
    p = SGMParams(max_disp=16, p1=7, p2=60, lr_mode="reagg",
                  fill_invalid=True)
    want = np.asarray(jstereo.stereo_sgm(jnp.asarray(il), jnp.asarray(ir),
                                         p, "pallas_tr"))
    ours = stereo_sgm(_t(il), _t(ir), p).numpy()
    _assert_disp_close(ours, want)
    _assert_disp_close(ours, g.sgm_stereo(il, ir, p))


@pytest.mark.parametrize("kw", [dict(lr_mode="reagg"),
                                dict(fill_invalid=True),
                                dict(lr_mode="reagg", num_paths=16,
                                     adaptive_p2=True, subpixel=False)])
def test_options_match_golden(kw):
    il, ir, _ = random_dot_stereo(30, 44, 16, seed=22)
    p = SGMParams(max_disp=16, p1=7, p2=60, **kw)
    _assert_disp_close(stereo_sgm(_t(il), _t(ir), p).numpy(),
                       g.sgm_stereo(il, ir, p))


def test_reagg_matches_frozen_fixture():
    fx = np.load(FIXDIR / "stereo_reagg.npz")
    p = SGMParams(max_disp=32, p1=7, p2=60, lr_mode="reagg")
    _assert_disp_close(stereo_sgm(_t(fx["img_l"]), _t(fx["img_r"]),
                                  p).numpy(), fx["disp"])


def test_right_disparity_matches_golden():
    il, ir, _ = random_dot_stereo(29, 41, 16, seed=23)
    p = SGMParams(max_disp=16, p1=7, p2=60, adaptive_p2=True)
    cost_r = g.cost_volume_stereo_right(g.census_transform(il),
                                        g.census_transform(ir), 16, 255)
    want = g.wta(g.aggregate_paths(cost_r, ir, p))
    ours = right_disparity_reagg(census_transform(_t(il))[None],
                                 census_transform(_t(ir))[None],
                                 _t(ir)[None], p)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours[0].numpy(), want)


def _holey_field(shape, seed):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0, 60, shape).astype(np.float32)
    f[rng.random(shape) < 0.4] = -1.0
    f[..., 0, :] = -1.0                      # a row with no valid pixel
    f[..., 1, :3] = -1.0                     # leading invalid run
    f[..., 2, -4:] = -1.0                    # trailing invalid run
    return f


@pytest.mark.parametrize("shape", [(5, 1), (6, 40)])
def test_interpolate_invalid_matches_jax_and_golden(shape):
    f = _holey_field(shape, shape[1])
    ours = ext.interpolate_invalid(_t(f)).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jext.interpolate_invalid(jnp.asarray(f))))
    np.testing.assert_array_equal(ours, g.interpolate_invalid(f))
    batch = _holey_field((3,) + shape, 5)
    got = ext.interpolate_invalid(_t(batch)).numpy()
    for k in range(3):
        np.testing.assert_array_equal(got[k], g.interpolate_invalid(batch[k]))


def test_lr_check_with_max_disp_matches_jax():
    rng = np.random.default_rng(24)
    d_left = rng.uniform(-1.4, 20.0, (9, 30)).astype(np.float32)
    d_left[0, :4] = [0.5, 1.5, 2.5, -0.5]     # rint ties go to even
    d_right = rng.integers(0, 20, (9, 30)).astype(np.int32)
    want = np.asarray(jext.lr_check(jnp.asarray(d_left),
                                    jnp.asarray(d_right), 1, 12))
    np.testing.assert_array_equal(
        ext.lr_check(_t(d_left), _t(d_right), 1, 12).numpy(), want)
