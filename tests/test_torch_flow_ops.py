"""PyTorch port: the modules of the flow path below the driver, on the CPU.

  * ops/cost.py: the flow cost volume in both layouts vs
    golden/flow.py::cost_volume_flow and JAX cost_volume_flow(_major);
  * K2 with the 2D label rule (sgm_sweep_plain, label_ext): each direction
    vs golden aggregate_one_path with make_neighbor_min_2d, the 8-path sum
    vs JAX aggregate_paths_tr(label_ext=...) in interpret mode, and a
    volume padded past nl with small pad costs (the pads take part in
    nothing);
  * K4 (extract_flow_plain) vs JAX extract_flow_major in interpret mode;
  * K5 (label_minor_from_major_plain) vs JAX label_minor_from_major;
  * the pyramid, the flow resampling and fb_check vs golden.
Integers exact; float planes equal to golden's within 1e-3 or exactly
where the arithmetic is the same.  The kernels themselves run on the card
in the `cuda`-marked tests at the end, which skip without one.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.flow as gf
import golden.sgm as g
from fsgm_tpu.io.synthetic import blockwise_flow_pair, constant_flow_pair
from fsgm_tpu.ops import cost as jcost
from fsgm_tpu.ops.census import census_transform as jcensus
from fsgm_tpu.ops.pallas import aggregate_tr as ptr
from fsgm_tpu.ops.pallas.extract_tr import extract_flow_major
from fsgm_tpu.ops.pallas.transpose_pallas import (
    T as JAX_T, label_minor_from_major as jax_label_minor_from_major)
from fsgm_tpu_torch.models import flow as tflow
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.cost import cost_volume_flow, cost_volume_flow_major
from fsgm_tpu_torch.ops.kernels import aggregate as agg
from fsgm_tpu_torch.ops.kernels import extract as kext
from fsgm_tpu_torch.ops.kernels import transpose as ktr
from fsgm_tpu_torch.params import DIRS_8

P1, P2 = 7, 60


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bases(shape, seed, lo=-2, hi=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, hi + 1, shape).astype(np.int32),
            rng.integers(lo, hi + 1, shape).astype(np.int32))


@pytest.fixture(scope="module")
def flow_level():
    """A 24x40 pair, its census both ways, random prior bases, radius 2."""
    i1, i2, _, _ = blockwise_flow_pair(24, 40, 3, seed=4)
    bu, bv = _bases(i1.shape, seed=5)
    return dict(img1=i1, img2=i2, bu=bu, bv=bv, r=2,
                gcen1=g.census_transform(i1), gcen2=g.census_transform(i2),
                tcen1=census_transform(_t(i1)), tcen2=census_transform(_t(i2)))


# --------------------------------------------------------------------------
# flow cost volume
# --------------------------------------------------------------------------

@pytest.mark.parametrize("radius,prior", [(2, "random"), (3, "random"),
                                          (2, "zero")])
def test_flow_cost_matches_golden_and_jax(flow_level, radius, prior):
    f = flow_level
    if prior == "zero":
        bu = bv = np.zeros(f["img1"].shape, np.int32)
    else:
        bu, bv = f["bu"], f["bv"]
    gold = gf.cost_volume_flow(f["gcen1"], f["gcen2"], bu, bv, radius)
    ours = cost_volume_flow(f["tcen1"], f["tcen2"], _t(bu), _t(bv), radius)
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy().astype(np.int64), gold)
    jc1 = jcensus(jnp.asarray(f["img1"]))
    jc2 = jcensus(jnp.asarray(f["img2"]))
    jax_minor = jcost.cost_volume_flow(jc1, jc2, jnp.asarray(bu),
                                       jnp.asarray(bv), radius)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_minor))
    nl = (2 * radius + 1) ** 2
    nl_pad = -(-nl // 32) * 32
    major = cost_volume_flow_major(f["tcen1"], f["tcen2"], _t(bu), _t(bv),
                                   radius, 255, nl_pad=nl_pad)
    jax_major = jcost.cost_volume_flow_major(
        jc1, jc2, jnp.asarray(bu), jnp.asarray(bv), radius, 255,
        nd_pad=nl_pad)
    assert tuple(major.shape) == (24, nl_pad, 40)
    np.testing.assert_array_equal(major.numpy(), np.asarray(jax_major))
    np.testing.assert_array_equal(
        major[:, :nl].transpose(1, 2).numpy(), ours.numpy())


def test_flow_cost_major_refuses_a_short_pad(flow_level):
    f = flow_level
    with pytest.raises(ValueError, match="nl_pad"):
        cost_volume_flow_major(f["tcen1"], f["tcen2"], _t(f["bu"]),
                               _t(f["bv"]), 2, nl_pad=16)


# --------------------------------------------------------------------------
# K2, 2D label rule
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flow_cost(flow_level):
    f = flow_level
    cost = gf.cost_volume_flow(f["gcen1"], f["gcen2"], f["bu"], f["bv"],
                               f["r"])
    return f["img1"], cost, 2 * f["r"] + 1


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("r", DIRS_8)
def test_sweep_2d_matches_golden_per_direction(flow_cost, r, adaptive):
    img, cost, e = flow_cost
    ti = _t(img)
    p2e = agg.p2_effective(ti, r, P1, P2, adaptive)
    ours = agg.sgm_sweep(_t(cost.astype(np.uint8)), p2e, r, P1,
                         s_dtype=torch.int32, label_ext=e)
    gold = g.aggregate_one_path(cost, img, r, P1, P2, adaptive,
                                neighbor_min=gf.make_neighbor_min_2d(e // 2))
    np.testing.assert_array_equal(ours.numpy().astype(np.int64), gold)


def test_aggregate_2d_matches_jax_tr_interpret():
    """The 8-path S of the 2D rule vs the TPU kernel (interpret mode) on a
    label-major volume padded to a sublane multiple, at 12x20, radius 1."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (12, 20), dtype=np.uint8)
    e, nl = 3, 9
    cost = rng.integers(0, 25, (12, 20, nl), dtype=np.uint8)
    s_max = 8 * (255 + P2)
    cost_hlw = np.full((12, 16, 20), 255, np.uint8)
    cost_hlw[:, :nl] = cost.transpose(0, 2, 1)
    want = np.asarray(ptr.aggregate_paths_tr(
        jnp.asarray(cost_hlw), jnp.asarray(img), DIRS_8, P1, P2, True,
        label_ext=e, s_max=s_max))[:, :, :nl]
    ours = agg.aggregate_paths(_t(cost), _t(img), DIRS_8, P1, P2, True,
                               s_max=s_max, label_ext=e)
    assert ours.dtype == torch.int16
    np.testing.assert_array_equal(ours.numpy(), want)
    plain = agg.aggregate_paths_plain(_t(cost), _t(img), DIRS_8, P1, P2,
                                      True, s_max=s_max, label_ext=e)
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("pad_value", [0, 255])
def test_pad_labels_take_part_in_nothing(flow_cost, pad_value):
    """Label slots past nl, even at cost 0 (which would win every min if
    they took part), leave S over the real labels unchanged and stay 0."""
    img, cost, e = flow_cost
    nl = e * e
    padded = np.full(cost.shape[:2] + (32,), pad_value, np.uint8)
    padded[..., :nl] = cost
    kw = dict(s_max=8 * (255 + P2), label_ext=e)
    want = agg.aggregate_paths(_t(cost.astype(np.uint8)), _t(img), DIRS_8,
                               P1, P2, False, **kw)
    ours = agg.aggregate_paths(_t(padded), _t(img), DIRS_8, P1, P2, False,
                               nl=nl, **kw)
    np.testing.assert_array_equal(ours[..., :nl].numpy(), want.numpy())
    assert not ours[..., nl:].any()


@pytest.mark.parametrize("kw,match", [
    (dict(label_ext=4), "label_ext"),            # 16 != 25 labels
    (dict(label_ext=5, nl=40), "nl"),            # more labels than slots
])
def test_sweep_refuses_inconsistent_label_counts(kw, match):
    cost = torch.zeros((4, 5, 32), dtype=torch.uint8)
    p2e = torch.full((4, 5), P2, dtype=torch.int32)
    if "nl" not in kw:
        cost = cost[..., :25].contiguous()
    with pytest.raises(ValueError, match=match):
        agg.sgm_sweep(cost, p2e, (0, 1), P1, **kw)


# --------------------------------------------------------------------------
# K4 extract_flow
# --------------------------------------------------------------------------

def _flow_s(kind, e, dtype, seed=0):
    """(H, W, D) S with nl = e^2 real labels and D the next multiple of 32;
    the pad slots hold values that would win the min if they were read."""
    rng = np.random.default_rng(seed)
    nl = e * e
    nd = -(-nl // 32) * 32
    hi = 4 if kind == "ties" else 2841
    s = np.zeros((10, 23, nd), dtype)
    s[..., :nl] = rng.integers(0, hi, (10, 23, nl))
    return s


@pytest.mark.parametrize("with_sub", [True, False])
@pytest.mark.parametrize("kind,e,dtype", [("random", 5, np.int16),
                                          ("ties", 5, np.int16),
                                          ("random", 9, np.int32),
                                          ("ties", 3, np.int32)])
def test_extract_flow_matches_extract_flow_major(kind, e, dtype, with_sub):
    s = _flow_s(kind, e, dtype)
    nl = e * e
    want = extract_flow_major(jnp.asarray(s[..., :nl].transpose(0, 2, 1)),
                              e, with_sub=with_sub)
    ours = kext.extract_flow(_t(s), nl, e, with_sub)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(ours[0].numpy(),
                                  np.argmin(s[..., :nl], axis=-1))
    if not with_sub:
        assert ours[1] is None and ours[2] is None and want[1] is None
        return
    for got, ref in zip(ours[1] + ours[2], want[1] + want[2]):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_extract_flow_tail_matches_golden_subpixel():
    """K4's six values through the float32 parabola == golden's
    subpixel_flow (float64) within 1e-6."""
    e = 7
    s = _flow_s("random", e, np.int16, seed=3)
    l_int, ut, vt = kext.extract_flow(_t(s), e * e, e)
    iv, iu = l_int // e, l_int % e
    du = tflow._parabola(iu, *ut, e).numpy()
    dv = tflow._parabola(iv, *vt, e).numpy()
    gdu, gdv = gf.subpixel_flow(s[..., :e * e].astype(np.int64),
                                l_int.numpy(), e // 2)
    np.testing.assert_allclose(du, gdu, atol=1e-6)
    np.testing.assert_allclose(dv, gdv, atol=1e-6)


def test_extract_flow_refuses_bad_label_grids():
    s = torch.zeros((2, 3, 32), dtype=torch.int16)
    with pytest.raises(ValueError, match="label_ext"):
        kext.extract_flow(s, 16, 5)
    with pytest.raises(TypeError):
        kext.extract_flow(s.to(torch.uint8), 25, 5)


# --------------------------------------------------------------------------
# K5 label_minor_from_major
# --------------------------------------------------------------------------

def test_transpose_matches_jax_kernel():
    rng = np.random.default_rng(13)
    vol = rng.integers(0, 256, (3, JAX_T, 130), dtype=np.uint8)
    want = np.asarray(jax_label_minor_from_major(jnp.asarray(vol)))
    ours = ktr.label_minor_from_major(_t(vol))
    assert tuple(ours.shape) == (3, 130, JAX_T) and ours.is_contiguous()
    np.testing.assert_array_equal(ours.numpy(), want[:, :130, :])


@pytest.mark.parametrize("shape", [(2, 81, 53), (1, 96, 33), (4, 7, 1)])
def test_transpose_any_label_count_and_width(shape):
    vol = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    ours = ktr.label_minor_from_major(_t(vol))
    np.testing.assert_array_equal(ours.numpy(), np.swapaxes(vol, 1, 2))


def test_transpose_refuses_other_dtypes():
    with pytest.raises(TypeError):
        ktr.label_minor_from_major(torch.zeros((2, 3, 4), dtype=torch.int16))


# --------------------------------------------------------------------------
# pyramid, resampling, fb_check
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_pyramid_matches_golden(shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    for gold, ours in zip(gf.build_pyramid(img, 4),
                          tflow.build_pyramid(_t(img), 4)):
        assert ours.dtype == torch.uint8
        np.testing.assert_array_equal(ours.numpy(), gold)


@pytest.mark.parametrize("out_hw", [(20, 26), (21, 27)])
def test_flow_resampling_matches_golden(out_hw):
    rng = np.random.default_rng(2)
    flow = rng.normal(0, 3, (10, 13, 2)).astype(np.float32)
    oh, ow = out_hw
    np.testing.assert_array_equal(
        tflow.upsample_flow_2x(_t(flow), oh, ow).numpy(),
        gf.upsample_flow_2x(flow.astype(np.float64), oh, ow))
    valid = rng.random((10, 13)) > 0.3
    np.testing.assert_array_equal(
        tflow.upsample_valid_2x(_t(valid), oh, ow).numpy(),
        gf.upsample_valid_2x(valid, oh, ow))
    big = rng.normal(0, 3, (oh, ow, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tflow.downsample_flow_2x(_t(big)).numpy(),
        gf.downsample_flow_2x(big.astype(np.float64)), atol=1e-6)


def test_fb_check_matches_golden():
    i1, i2, gt = constant_flow_pair(30, 44, 2, -1, seed=9)
    rng = np.random.default_rng(3)
    fwd = (gt + rng.normal(0, 0.6, gt.shape)).astype(np.float32)
    bwd = (-gt + rng.normal(0, 0.6, gt.shape)).astype(np.float32)
    fwd[0, 0] = (2.5, -0.5)          # rint ties: half to even both ways
    fwd[5, 40] = (9.0, 0.0)          # lookup outside the image
    gold = gf.fb_check(fwd.astype(np.float64), bwd.astype(np.float64), 1.0)
    ours = tflow.fb_check(_t(fwd), _t(bwd), 1.0).numpy()
    np.testing.assert_array_equal(ours, gold)
    assert 0 < ours.mean() < 1


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_k4_extract_flow_kernel_on_the_card(card, dtype):
    for kind, e in (("random", 9), ("ties", 5)):
        s = _t(_flow_s(kind, e, np.int16 if dtype == torch.int16
                       else np.int32)).to(card)
        got = kext.extract_flow(s, e * e, e)
        want = kext.extract_flow_plain(s, e * e, e)
        for a, b in zip((got[0],) + got[1] + got[2],
                        (want[0],) + want[1] + want[2]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_k5_transpose_kernel_on_the_card(card):
    for shape in ((3, 96, 1242), (2, 81, 53), (1, 7, 1)):
        vol = torch.randint(0, 256, shape, dtype=torch.uint8).to(card)
        assert torch.equal(ktr.label_minor_from_major(vol),
                           ktr.label_minor_from_major_plain(vol))


@pytest.mark.cuda
def test_k2_2d_sweep_kernel_on_the_card(card, flow_cost):
    img, cost, e = flow_cost
    nl = e * e
    padded = np.zeros(cost.shape[:2] + (32,), np.uint8)
    padded[..., :nl] = cost
    c, ti = _t(padded).to(card), _t(img).to(card)
    for r in DIRS_8:
        p2e = agg.p2_effective(ti, r, P1, P2, True)
        got = agg.sgm_sweep(c, p2e, r, P1, s_dtype=torch.int32, label_ext=e,
                            nl=nl)
        want = agg.sgm_sweep_plain(c, p2e, r, P1, label_ext=e, nl=nl)
        assert torch.equal(got, want)
