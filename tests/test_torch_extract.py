"""PyTorch port: K3 extraction (plain version on the CPU) and the tail.

The five K3 planes (d_int, s_m, s_0, s_p, valid) are held exactly to the
TPU kernel they replace, extract_tr.extract_stereo_major(..., with_sub,
with_rwta, with_lr=1) on the label-major S (interpret mode), including a
volume full of ties and one whose right-hand columns sit at s_invalid.
The plain references (wta, neighborhood_of_min, wta_right_from_s,
subpixel_from_neighborhood, lr_check, median_filter_3x3) are held to
fsgm_tpu/ops/extract.py and golden/sgm.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.sgm as g
from fsgm_tpu.ops import extract as jext
from fsgm_tpu.ops.pallas.extract_tr import extract_stereo_major
from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.kernels import extract as kext

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


@pytest.mark.parametrize("with_sub", [True, False])
@pytest.mark.parametrize("kind", ["random", "ties", "invalid_right"])
def test_extract_matches_extract_stereo_major(kind, with_sub):
    s = _volume(kind, seed=len(kind))
    want = extract_stereo_major(jnp.transpose(jnp.asarray(s), (0, 2, 1)),
                                S_INVALID, with_sub=with_sub,
                                with_rwta=True, with_lr=1)
    ours = kext.extract_stereo(torch.from_numpy(s), S_INVALID, 1, with_sub)
    names = ("d_int", "s_m", "s_0", "s_p", "valid")
    for name, a, b in zip(names, ours, want):
        assert a.dtype == torch.int32, name
        if b is None:      # JAX skips the neighbourhood without with_sub
            b = ext.neighborhood_of_min(torch.from_numpy(s), ours[0])[
                names.index(name) - 1]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def test_extract_int32_volume_matches_plain_parts():
    rng = np.random.default_rng(9)
    s = torch.from_numpy(rng.integers(0, 1 << 20, size=(6, 33, 32),
                                      dtype=np.int32))
    d, s_m, s_0, s_p, valid = kext.extract_stereo(s, 1 << 21, 2, True)
    np.testing.assert_array_equal(d.numpy(), np.argmin(s.numpy(), axis=2))
    disp = ext.subpixel_from_neighborhood(d, s_m, s_0, s_p, 32)
    rho = ext.wta_right_from_s(s, 1 << 21)
    np.testing.assert_array_equal(
        valid.numpy() != 0, ext.lr_check(disp, rho, 2).numpy() != -1.0)


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


@pytest.mark.parametrize("bad", ["dtype", "rank", "s_invalid"])
def test_extract_wrapper_rejects_bad_input(bad):
    s = torch.zeros((2, 3, 32), dtype=torch.int16)
    args = {"dtype": (s.to(torch.float32), 10), "rank": (s[0], 10),
            "s_invalid": (s, 1 << 22)}[bad]
    with pytest.raises((TypeError, ValueError)):
        kext.extract_stereo(*args)
