"""PyTorch port: disparity-axis sharding (parallel/disparity_sharded.py)
against the JAX package's stereo_sgm_dsharded and the port's stereo_sgm.

The labels are split into td slices (here td CPU devices); every integer
stage is exact and the disparity is compared bit for bit (tolerance 0):
  * td in {2, 4} x adaptive P2 against one JAX stereo_sgm_dsharded call a
    P2 mode (on td = 2 and td = 4 of conftest's 8 virtual CPU devices, so
    two JAX compiles): the result does not depend on td;
  * 16 paths, and config 2's switches (LR, subpixel, median on and off)
    against the port's stereo_sgm;
  * the pieces: a cost slice is the full volume's slice, one path's L over
    slices is the unsharded L;
  * max_disp % td, lr_mode="reagg" and fill_invalid raise.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsgm_tpu.params import SGMParams as JSGMParams
from fsgm_tpu.parallel.disparity_sharded import \
    stereo_sgm_dsharded as jax_dsharded
from fsgm_tpu_torch import SGMParams, load_preset, stereo_sgm
from fsgm_tpu_torch.io import random_dot_stereo
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.kernels.aggregate import (p2_effective,
                                                  sgm_sweep_plain)
from fsgm_tpu_torch.ops.kernels.cost import census_cost_plain
from fsgm_tpu_torch.parallel.disparity_sharded import (
    aggregate_one_path_dsharded, cost_volume_slice, stereo_sgm_dsharded)


CONFIG2 = Path(__file__).resolve().parents[1] / "configs" / "kitti_stereo.json"


def _pair(h, w, d, seed):
    il, ir, _ = random_dot_stereo(h, w, d, seed=seed)
    return il, ir


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the cores, and these
    tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX stereo_sgm_dsharded at 32x48, D=16, per P2 mode."""
    il, ir = _pair(32, 48, 16, 13)
    out = {}
    for adaptive, td in ((False, 2), (True, 4)):
        mesh = jax.make_mesh((td,), ("td",), devices=jax.devices()[:td])
        p = JSGMParams(max_disp=16, p1=7, p2=60, adaptive_p2=adaptive)
        out[adaptive] = np.asarray(jax_dsharded(jnp.asarray(il),
                                                jnp.asarray(ir), p, mesh))
    return il, ir, out


@pytest.mark.parametrize("td", [2, 4])
@pytest.mark.parametrize("adaptive", [False, True])
def test_equals_jax_dsharded(jax_ref, td, adaptive):
    il, ir, want = jax_ref
    p = SGMParams(max_disp=16, p1=7, p2=60, adaptive_p2=adaptive)
    got = stereo_sgm_dsharded(torch.from_numpy(il), torch.from_numpy(ir), p,
                              ["cpu"] * td)
    np.testing.assert_array_equal(got.numpy(), want[adaptive])


def test_16_paths_equal_stereo_sgm():
    """16 paths (the knight directions step two rows), 37x53, D=32,
    adaptive P2, td = 4."""
    il, ir = (torch.from_numpy(x) for x in _pair(37, 53, 32, 5))
    p = SGMParams(max_disp=32, p1=7, p2=60, num_paths=16, adaptive_p2=True)
    assert torch.equal(stereo_sgm_dsharded(il, ir, p, ["cpu"] * 4),
                       stereo_sgm(il, ir, p))


def test_config2_switches_equal_stereo_sgm():
    """configs/kitti_stereo.json's parameters (D cut to 32 for a 40x64
    pair), and with each of the tail's switches off in turn, td = 2."""
    p = dataclasses.replace(load_preset(str(CONFIG2))["sgm"],
                            max_disp=32)
    il, ir = (torch.from_numpy(x) for x in _pair(40, 64, 32, 7))
    for off in (None, "lr_check", "subpixel", "median_filter"):
        q = dataclasses.replace(p, **{off: False}) if off else p
        assert torch.equal(stereo_sgm_dsharded(il, ir, q, ["cpu", "cpu"]),
                           stereo_sgm(il, ir, q)), off


def test_slices_and_one_path_equal_unsharded():
    """cost_volume_slice is a slice of the full cost volume, and one
    diagonal path's L over 4 slices is the unsharded L (int32, exact)."""
    il, ir = (torch.from_numpy(x) for x in _pair(20, 36, 16, 3))
    cl, cr = census_transform(il), census_transform(ir)
    full = census_cost_plain(cl, cr, 16, 255)
    slices = [cost_volume_slice(cl, cr, 4 * k, 4, 255) for k in range(4)]
    assert torch.equal(torch.cat(slices, -1), full)
    r = (-1, 1)
    want = sgm_sweep_plain(full, p2_effective(il, r, 7, 60, True), r, 7)
    got = aggregate_one_path_dsharded(slices, il, r, 7, 60, True)
    assert torch.equal(torch.cat(got, -1), want)


def test_refusals():
    """D that the slices do not divide raises, as in the reference; the
    options the reference silently ignores here raise too."""
    il, ir = (torch.from_numpy(x) for x in _pair(16, 24, 8, 1))
    for kw, td in ((dict(max_disp=16), 3), (dict(lr_mode="reagg"), 2),
                   (dict(fill_invalid=True), 2)):
        p = SGMParams(**{"max_disp": 8, "p1": 7, "p2": 60, **kw})
        with pytest.raises(ValueError):
            stereo_sgm_dsharded(il, ir, p, ["cpu"] * td)
