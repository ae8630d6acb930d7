"""PyTorch port: fSGM flow end to end on the CPU against golden/flow.py.

flow_fsgm vs golden/flow.py::fsgm_flow for every fb_backward mode (full,
cheap, single, half) on both fb_grid grids and with fb_check off: validity
planes equal, flow within 1e-3 on valid pixels (float32 vs golden's
float64).  The prior, the fixtures, JAX's own pipeline, the plain twin and
the batch are tested in test_torch_flow_pipeline.py, the CLI and the
profiler in test_torch_cli.py.  The kernels run on the card in the
`cuda`-marked test at the end.
"""

import dataclasses

import numpy as np
import pytest
import torch

import golden.flow as gf
from fsgm_tpu.io.synthetic import constant_flow_pair
from fsgm_tpu.params import FlowParams as JaxFlowParams
from fsgm_tpu_torch import FlowParams, flow_fsgm, flow_fsgm_reference
from fsgm_tpu_torch.ops.kernels import _build

TOL = 1e-3
BASE = dict(search_radius=3, levels=3, p1=7, p2=60)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_flow_close(flow, valid, want_flow, want_valid):
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(flow[want_valid], want_flow[want_valid],
                               atol=TOL)


@pytest.fixture(scope="module")
def pair():
    img1, img2, _ = constant_flow_pair(48, 64, 2, -1, seed=3)
    return img1, img2


def _run(fn, img1, img2, params, **kw):
    flow, valid = fn(_t(img1), _t(img2), params, **kw)
    assert flow.dtype == torch.float32 and valid.dtype == torch.bool
    assert tuple(flow.shape) == img1.shape + (2,)
    return flow.numpy(), valid.numpy()


@pytest.mark.parametrize("fb_grid", ["full", "half"])
@pytest.mark.parametrize("mode", ["full", "cheap", "single", "half"])
def test_every_backward_mode_matches_golden(pair, mode, fb_grid):
    img1, img2 = pair
    kw = dict(BASE, fb_backward=mode, fb_grid=fb_grid)
    gold, gold_valid = gf.fsgm_flow(img1, img2, JaxFlowParams(**kw))
    flow, valid = _run(flow_fsgm, img1, img2, FlowParams(**kw))
    _assert_flow_close(flow, valid, gold, gold_valid)
    assert 0.5 < valid.mean() < 1


def test_without_fb_check_matches_golden(pair):
    img1, img2 = pair
    kw = dict(BASE, fb_check=False)
    gold, _ = gf.fsgm_flow(img1, img2, JaxFlowParams(**kw))
    flow, valid = _run(flow_fsgm, img1, img2, FlowParams(**kw))
    assert valid.all()
    np.testing.assert_allclose(flow, gold, atol=TOL)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flow_kernels_match_reference_on_the_card(card, pair):
    img1, img2 = pair
    p = FlowParams(**dict(BASE, fb_backward="half", fb_grid="half",
                          adaptive_p2=True))
    t1, t2 = _t(img1).to(card), _t(img2).to(card)
    _build.LAUNCHES.clear()
    flow, valid = flow_fsgm(t1, t2, p)
    assert all(_build.LAUNCHES[k] > 0 for k in ("extract_flow", "flow_cost"))
    # K2: family launches where they fill the card better (aggregate_paths)
    assert _build.LAUNCHES["sgm_sweep"] + _build.LAUNCHES[
        "sgm_sweep_family"] > 0
    ref, ref_valid = flow_fsgm_reference(t1, t2, p)
    assert torch.equal(valid, ref_valid)
    assert float((flow - ref).abs().max()) <= TOL
    gold, gold_valid = gf.fsgm_flow(img1, img2, JaxFlowParams(**dataclasses
                                                              .asdict(p)))
    _assert_flow_close(flow.cpu().numpy(), valid.cpu().numpy(), gold,
                       gold_valid)
