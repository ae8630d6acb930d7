"""The plain reference (benchmark/reference) against the program's own
output on the CPU at fixture sizes: bit for bit, with every switch of
configs 2 and 4, config 3's 16 paths and adaptive P2, and the other
forward-backward modes the reference covers."""

import types

import pytest
import torch

from benchmark import spec
from benchmark.inputs import blockwise_flow, random_dot_stereo
from benchmark.reference import flow as ref_flow
from benchmark.reference import sgm
from benchmark.reference import stereo as ref_stereo
from benchmark.tests.conftest import shrink


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("paths,adaptive", [(8, False), (16, False),
                                            (16, True)])
@pytest.mark.parametrize("hw,max_disp", [((40, 56), 32), ((96, 128), 64)])
def test_stereo_reference_equals_program(hw, max_disp, paths, adaptive):
    """Config 2, and config 3's 16 paths with P2 constant and adaptive."""
    from fsgm_tpu_torch import SGMParams, stereo_sgm_batch
    cfg = spec.load_config("kitti_stereo")
    cfg = {**cfg, "height": hw[0], "width": hw[1],
           "params": {**cfg["params"], "max_disp": max_disp,
                      "num_paths": paths, "adaptive_p2": adaptive}}
    left, right, _ = random_dot_stereo.make(3, cfg, _gen(2 ** 31 + 99))
    want = stereo_sgm_batch(left, right,
                            SGMParams(**spec.params_kwargs(cfg)))
    (got,) = ref_stereo.run(left, right, cfg, block=2)
    assert torch.equal(got, want)
    assert 0 < int((got < 0).sum()) < got.numel() // 2  # the LR check bites


def test_knight_moves_start_their_paths_at_the_edges():
    """For each knight move r, L_r = C exactly where p - r lies outside the
    frame (the first |dy| scan rows and |dx| edge columns), and not
    everywhere inside; P2' adaptive, 3 frames at 40 x 56."""
    cfg = shrink(spec.load_config("kitti_stereo"))
    p = cfg["params"]
    left, right, _ = random_dot_stereo.make(3, cfg, _gen(2 ** 31 + 41))
    window = tuple(p["census_window"])
    cost = ref_stereo.cost_volume(sgm.census(left, window),
                                  sgm.census(right, window), p["max_disp"],
                                  p["invalid_cost"]).to(torch.int32)
    h, w = cfg["height"], cfg["width"]
    ys, xs = torch.arange(h)[:, None], torch.arange(w)[None, :]
    for r in sgm.DIRS_16[8:]:
        l_r = sgm.path_cost(cost, r, p["p1"],
                            ref_stereo.p2_table(left, r, p["p1"], p["p2"]))
        outside = ((ys - r[0] < 0) | (ys - r[0] >= h)
                   | (xs - r[1] < 0) | (xs - r[1] >= w))
        assert int(outside.sum()) == (abs(r[0]) * w
                                      + abs(r[1]) * (h - abs(r[0])))
        assert torch.equal(l_r[:, outside], cost[:, outside]), r
        assert not torch.equal(l_r[:, ~outside], cost[:, ~outside]), r


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
    ("kitti_stereo", "fill_invalid", True),
    ("kitti_flow", "fb_backward", "cheap")])
def test_reference_refuses_what_it_does_not_cover(config, key, value):
    """Refused alone, and for stereo beside config 3's 16 paths and adaptive
    P2, which the refusal does not name (they are covered: a run with them
    alone gives its disparity)."""
    cfg = shrink(spec.load_config(config))
    ref = spec.load_reference(cfg["kind"])
    img = torch.zeros((1, cfg["height"], cfg["width"]), dtype=torch.uint8)
    sets = [{key: value}]
    if cfg["kind"] == "stereo":
        config3 = {"num_paths": 16, "adaptive_p2": True}
        (disp,) = ref.run(img, img, {**cfg, "params": {**cfg["params"],
                                                       **config3}})
        assert disp.shape == img.shape
        sets.append({key: value, **config3})
    for changed in sets:
        bad = {**cfg, "params": {**cfg["params"], **changed}}
        with pytest.raises(ValueError, match=rf"reference covers.* got "
                                             rf"\{{'{key}': {value!r}\}}$"):
            ref.run(img, img, bad)


def test_shrink_takes_a_kind_it_has_never_heard_of(monkeypatch):
    """A configuration of a new kind brings its test sizes in its own
    reference file: shrink needs no table of kinds."""
    mesh = types.SimpleNamespace(
        SMALL=dict(height=32, width=48, params=dict(max_disp=16)))
    monkeypatch.setattr(spec, "load_reference",
                        lambda kind: {"ranks": mesh}[kind])
    cfg = {"kind": "ranks", "height": 2160, "width": 3840,
           "params": {"max_disp": 128, "ranks": 4}}
    assert shrink(cfg) == {"kind": "ranks", "height": 32, "width": 48,
                           "params": {"max_disp": 16, "ranks": 4}}
