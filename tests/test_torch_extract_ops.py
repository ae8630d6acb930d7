"""PyTorch port: the plain extraction references of ops/extract.py.

wta, neighborhood_of_min, wta_right_from_s, subpixel_from_neighborhood,
lr_check and median_filter_3x3 are held to fsgm_tpu/ops/extract.py and
golden/sgm.py on the same numpy volumes, exact (subpixel against golden's
float64 within 1e-5).  K3 itself is tested in test_torch_extract.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.sgm as g
from fsgm_tpu.ops import extract as jext
from fsgm_tpu_torch.ops import extract as ext

S_INVALID = 30000


def _volume(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 2900, size=(24, 47, 16)).astype(np.int16)
    if kind == "ties":
        return rng.integers(0, 4, size=(16, 40, 32)).astype(np.int16)
    s = rng.integers(0, 2900, size=(8, 70, 64)).astype(np.int16)
    s[:, -20:, 40:] = S_INVALID       # right columns all at s_invalid
    s[:, -3:, :] = S_INVALID
    return s


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_wta_and_neighbourhood_match_jax(kind):
    s = _volume(kind, seed=3)
    d = ext.wta(torch.from_numpy(s))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jext.wta(s)))
    for a, b in zip(ext.neighborhood_of_min(torch.from_numpy(s), d),
                    jext.neighborhood_of_min(jnp.asarray(s),
                                             jnp.asarray(d.numpy()))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["random", "ties", "invalid_right"])
def test_wta_right_matches_jax_and_golden(kind):
    s = _volume(kind, seed=4)
    ours = ext.wta_right_from_s(torch.from_numpy(s), S_INVALID).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jext.wta_right_from_s(jnp.asarray(s), S_INVALID)))
    np.testing.assert_array_equal(ours, g.wta_right_from_S(s, S_INVALID))


def test_subpixel_and_lr_check_match_jax():
    s = _volume("random", seed=5)
    ts = torch.from_numpy(s)
    d = ext.wta(ts)
    parts = ext.neighborhood_of_min(ts, d)
    disp = ext.subpixel_from_neighborhood(d, *parts, 16)
    jd = jnp.asarray(d.numpy())
    jdisp = jext.subpixel_from_neighborhood(
        jd, *(jnp.asarray(p.numpy()) for p in parts), 16)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    np.testing.assert_allclose(disp.numpy(),
                               g.subpixel_refine(s, d.numpy()), atol=1e-5)
    rho = ext.wta_right_from_s(ts, S_INVALID)
    ours = ext.lr_check(disp, rho, 1).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jext.lr_check(jdisp, jnp.asarray(rho.numpy()), 1,
                                       16)))


@pytest.mark.parametrize("shape", [(9, 13), (1, 5), (30, 2)])
def test_median_matches_jax_and_golden(shape):
    rng = np.random.default_rng(shape[0] * shape[1])
    f = rng.normal(0, 10, size=shape).astype(np.float32)
    f[rng.random(shape) < 0.3] = -1.0
    ours = ext.median_filter_3x3(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jext.median_filter_3x3(jnp.asarray(f))))
    np.testing.assert_array_equal(ours, g.median_filter_3x3(f))
