"""PyTorch port: census transform, Hamming distance and the K1 cost volume.

Held against the JAX package on the same numpy inputs, exact:
  * census vs fsgm_tpu/ops/census.py (JAX u32 words combined as
    w0 | w1 << 32 into the port's one int64 word) for three windows;
  * the cost volume (the plain version K1 is held to on the card) vs the
    two TPU builders it replaces, cost_tr.cost_volume_hlw (strided, as on
    the main path) and cost_tr.cost_volume_wlh, their pads sliced off;
  * over (B, H, W) census, left and right reference, vs the third one,
    cost_tr.cost_volume_wlh_batch (interpret mode) re-laid out to
    (B, H, W, D), and vs cost_volume_stereo / _right per frame.
The CUDA kernel itself runs only on the card (chip_smoke.py); here the
wrapper must take the plain version for CPU tensors, and the loader must
fail loudly without nvcc.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.sgm as g
from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu.ops import cost as jcost
from fsgm_tpu.ops.census import census_transform as jax_census
from fsgm_tpu.ops.pallas import cost_tr
from fsgm_tpu_torch.ops import census
from fsgm_tpu_torch.ops.kernels import _build, cost


def _jax_words_as_u64(img, window):
    words = np.asarray(jax_census(jnp.asarray(img), window)).astype(np.uint64)
    out = words[..., 0]
    if words.shape[-1] > 1:
        out = out | (words[..., 1] << np.uint64(32))
    return out


@pytest.mark.parametrize("window", [(5, 5), (7, 7), (9, 7)])
def test_census_matches_jax_and_golden(window):
    img = np.random.default_rng(sum(window)).integers(
        0, 256, size=(23, 41), dtype=np.uint8)
    ours = census.census_transform(torch.from_numpy(img), window)
    assert ours.dtype == torch.int64
    ours = ours.numpy().astype(np.uint64)
    np.testing.assert_array_equal(ours, _jax_words_as_u64(img, window))
    np.testing.assert_array_equal(ours, g.census_transform(img, window))


def test_census_rejects_oversized_window():
    with pytest.raises(ValueError):
        census.census_transform(torch.zeros((4, 4), dtype=torch.uint8),
                                (9, 9))


def test_popcount_matches_numpy():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 62, size=4096, dtype=np.int64)
    b = rng.integers(0, 1 << 62, size=4096, dtype=np.int64)
    a[:3] = [0, (1 << 62) - 1, 1]
    ours = census.hamming(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(ours, np.bitwise_count(a ^ b))


def _pad8(n):
    return -(-n // 8) * 8


@pytest.mark.parametrize("h,w,d,win", [(40, 56, 16, (5, 5)),
                                       (37, 53, 16, (5, 5)),
                                       (24, 40, 8, (9, 7))])
def test_cost_matches_cost_tr_builders(h, w, d, win):
    il, ir, _ = random_dot_stereo(h, w, d, seed=1)
    ours = cost.census_cost(census.census_transform(torch.from_numpy(il), win),
                            census.census_transform(torch.from_numpy(ir), win),
                            d, 255)
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == (h, w, d)
    ours = ours.numpy()
    cl = jax_census(jnp.asarray(il), win)
    cr = jax_census(jnp.asarray(ir), win)
    hlw = np.asarray(cost_tr.cost_volume_hlw(cl, cr, d, 255, False, 8,
                                             win == (5, 5)))
    np.testing.assert_array_equal(ours, hlw[:h].transpose(0, 2, 1))
    wlh = np.asarray(cost_tr.cost_volume_wlh(cl, cr, d, 255))
    assert wlh.shape == (_pad8(w), d, _pad8(h))
    np.testing.assert_array_equal(ours, wlh[:w, :, :h].transpose(2, 0, 1))
    gold = g.cost_volume_stereo(g.census_transform(il, win),
                                g.census_transform(ir, win), d, 255)
    np.testing.assert_array_equal(ours, gold)


def test_cost_invalid_columns_and_wide_disparity():
    """x - d < 0 takes invalid_cost, also where D exceeds the width."""
    il, ir, _ = random_dot_stereo(9, 20, 8, seed=3)
    cl = census.census_transform(torch.from_numpy(il))
    cr = census.census_transform(torch.from_numpy(ir))
    ours = cost.census_cost(cl, cr, 32, 200).numpy()
    gold = g.cost_volume_stereo(g.census_transform(il),
                                g.census_transform(ir), 32, 200)
    np.testing.assert_array_equal(ours, gold)
    assert (ours[:, 3, 4:] == 200).all()


@pytest.mark.parametrize("right_reference", [False, True])
def test_batched_cost_matches_cost_volume_wlh_batch(right_reference):
    B, H, W, D = 3, 37, 53, 16
    pairs = [random_dot_stereo(H, W, D, seed=10 + s) for s in range(B)]
    il = np.stack([p[0] for p in pairs])
    ir = np.stack([p[1] for p in pairs])
    jcl = jnp.stack([jax_census(jnp.asarray(a)) for a in il])
    jcr = jnp.stack([jax_census(jnp.asarray(a)) for a in ir])
    folded = np.asarray(cost_tr.cost_volume_wlh_batch(jcl, jcr, D, 255,
                                                      right_reference))
    hp, wp = _pad8(H), _pad8(W)
    want = folded.reshape(wp, D, B, hp).transpose(2, 3, 0, 1)[:, :H, :W]
    cl = census.census_transform(torch.from_numpy(il))
    cr = census.census_transform(torch.from_numpy(ir))
    _build.LAUNCHES.clear()
    ours = cost.census_cost(cl, cr, D, 255, right_reference).numpy()
    assert sum(_build.LAUNCHES.values()) == 0  # CPU: the plain version
    assert ours.shape == (B, H, W, D) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, want)
    per_frame = (jcost.cost_volume_stereo_right if right_reference
                 else jcost.cost_volume_stereo)
    for k in range(B):
        np.testing.assert_array_equal(
            ours[k], np.asarray(per_frame(jcl[k], jcr[k], D, 255)))


@pytest.mark.parametrize("bad", ["dtype", "shape", "invalid_cost"])
def test_cost_wrapper_rejects_bad_input(bad):
    c = torch.zeros((4, 6), dtype=torch.int64)
    args = {"dtype": (c.to(torch.int32), c, 4, 255),
            "shape": (c, c[:, :5], 4, 255),
            "invalid_cost": (c, c, 4, 256)}[bad]
    with pytest.raises((TypeError, ValueError)):
        cost.census_cost(*args)


def test_cpu_tensors_take_the_plain_version_without_launching():
    _build.LAUNCHES.clear()
    c = torch.zeros((3, 5), dtype=torch.int64)
    cost.census_cost(c, c, 4)
    assert sum(_build.LAUNCHES.values()) == 0


def test_kernel_loader_names_nvcc_when_it_is_missing(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_library("cost")
    assert not (tmp_path / "build").exists()
