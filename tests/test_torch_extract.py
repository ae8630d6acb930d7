"""PyTorch port: K3 extraction (plain version on the CPU) and the tail.

The five K3 planes (d_int, s_m, s_0, s_p, valid) are held exactly to the
TPU kernel they replace, extract_tr.extract_stereo_major(..., with_sub,
with_rwta, with_lr=1) on the label-major S (interpret mode), including a
volume full of ties and one whose right-hand columns sit at s_invalid.
The plain references it is built from are held to the JAX package in
test_torch_extract_ops.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

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


@pytest.mark.parametrize("bad", ["dtype", "rank", "s_invalid"])
def test_extract_wrapper_rejects_bad_input(bad):
    s = torch.zeros((2, 3, 32), dtype=torch.int16)
    args = {"dtype": (s.to(torch.float32), 10), "rank": (s[0], 10),
            "s_invalid": (s, 1 << 22)}[bad]
    with pytest.raises((TypeError, ValueError)):
        kext.extract_stereo(*args)
