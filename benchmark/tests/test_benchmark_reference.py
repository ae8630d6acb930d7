"""The plain reference (benchmark/reference) against the program's own
output on the CPU at fixture sizes: bit for bit, with every switch of
configs 2 and 4 and the other forward-backward modes the reference
covers."""

import pytest
import torch

from benchmark import spec
from benchmark.inputs import blockwise_flow, random_dot_stereo
from benchmark.reference import flow as ref_flow
from benchmark.reference import stereo as ref_stereo
from benchmark.tests.conftest import shrink


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("hw,max_disp", [((40, 56), 32), ((96, 128), 64)])
def test_stereo_reference_equals_program(hw, max_disp):
    from fsgm_tpu_torch import SGMParams, stereo_sgm_batch
    cfg = spec.load_config("kitti_stereo")
    cfg = {**cfg, "height": hw[0], "width": hw[1],
           "params": {**cfg["params"], "max_disp": max_disp}}
    left, right, _ = random_dot_stereo.make(3, cfg, _gen(2 ** 31 + 99))
    want = stereo_sgm_batch(left, right,
                            SGMParams(**spec.params_kwargs(cfg)))
    (got,) = ref_stereo.run(left, right, cfg, block=2)
    assert torch.equal(got, want)
    assert 0 < int((got < 0).sum()) < got.numel() // 2  # the LR check bites


@pytest.mark.parametrize("fb", [("half", "half"), ("full", "full"),
                                ("half", "full"), ("full", "half")])
def test_flow_reference_equals_program(fb):
    from fsgm_tpu_torch import FlowParams, flow_fsgm_batch
    cfg = shrink(spec.load_config("kitti_flow"))
    cfg["params"].update(fb_backward=fb[0], fb_grid=fb[1])
    img1, img2, _ = blockwise_flow.make(3, cfg, _gen(2 ** 31 + 7),
                                        max_mag=3)
    want = flow_fsgm_batch(img1, img2, FlowParams(**spec.params_kwargs(cfg)))
    got = ref_flow.run(img1, img2, cfg, block=2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0.3 < float(got[1].float().mean()) < 1.0


def test_flow_reference_at_config4_labels():
    """Config 4's own 81 labels and 3 levels at 96 x 128."""
    from fsgm_tpu_torch import FlowParams, flow_fsgm
    cfg = spec.load_config("kitti_flow")
    cfg = {**cfg, "height": 96, "width": 128,
           "params": {**cfg["params"], "levels": 3}}
    img1, img2, _ = blockwise_flow.make(1, cfg, _gen(5))
    want = flow_fsgm(img1[0], img2[0], FlowParams(**spec.params_kwargs(cfg)))
    got = ref_flow.run(img1, img2, cfg)
    assert torch.equal(got[0][0], want[0]) and torch.equal(got[1][0], want[1])


@pytest.mark.parametrize("config,size,want", [
    ("kitti_stereo", None, 16), ("kitti_flow", None, 8),
    ("kitti_stereo", (2160, 3840), 1), ("kitti_flow", (2160, 3840), 1)])
def test_default_block_follows_the_configuration(config, size, want):
    """16 and 8 frames at the cells' own sizes, one 4K frame."""
    cfg = spec.load_config(config)
    if size is not None:
        cfg = {**cfg, "height": size[0], "width": size[1]}
    assert spec.load_reference(cfg["kind"]).default_block(cfg) == want


@pytest.mark.parametrize("config", ["kitti_stereo", "kitti_flow"])
def test_blocks_change_no_output(config):
    """Frame by frame equals the default block (all 3 frames at once here),
    bit for bit."""
    cfg = shrink(spec.load_config(config))
    make = (random_dot_stereo if cfg["kind"] == "stereo"
            else blockwise_flow).make
    a, b, _ = make(3, cfg, _gen(2 ** 31 + 21))
    ref = spec.load_reference(cfg["kind"])
    assert ref.default_block(cfg) >= 3
    whole, single = ref.run(a, b, cfg), ref.run(a, b, cfg, block=1)
    assert len(whole) == len(single)
    assert all(torch.equal(x, y) for x, y in zip(whole, single))


@pytest.mark.parametrize("config,key,value", [
    ("kitti_stereo", "lr_mode", "reagg"),
    ("kitti_flow", "fb_backward", "cheap")])
def test_reference_refuses_what_it_does_not_cover(config, key, value):
    cfg = shrink(spec.load_config(config))
    cfg["params"][key] = value
    img = torch.zeros((1, cfg["height"], cfg["width"]), dtype=torch.uint8)
    with pytest.raises(ValueError, match="reference covers"):
        spec.load_reference(cfg["kind"]).run(img, img, cfg)
