"""PyTorch port: fSGM flow on the CPU against fixtures, JAX and its twin.

  * flow_fsgm with a temporal prior vs golden/flow.py::fsgm_flow;
  * vs the frozen fixtures tests/fixtures/flow_2lvl.npz (flow_fsgm) and
    flow_seq_3frame.npz (flow_sequence), flow_sequence with track_params
    vs golden, and vs JAX flow_fsgm(..., "xla"): validity planes equal,
    flow within 1e-3 on valid pixels;
  * flow_fsgm (padded label-major build, transposes, padded S) equal to
    flow_fsgm_reference (label-minor, unpadded) bit for bit on the CPU,
    launching no kernel; flow_fsgm_batch equal to per-frame flow_fsgm;
    mismatched inputs refused.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.flow as gf
from fsgm_tpu.io.synthetic import (blockwise_flow_pair, constant_flow_pair,
                                   constant_flow_sequence)
from fsgm_tpu.models.flow import flow_fsgm as jax_flow_fsgm
from fsgm_tpu.params import FlowParams as JaxFlowParams
from fsgm_tpu_torch import (FlowParams, flow_fsgm, flow_fsgm_batch,
                            flow_fsgm_reference, flow_sequence)
from fsgm_tpu_torch.ops.kernels import _build

FIXDIR = Path(__file__).resolve().parents[1] / "tests" / "fixtures"
TOL = 1e-3
BASE = dict(search_radius=3, levels=3, p1=7, p2=60)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_flow_close(flow, valid, want_flow, want_valid):
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(flow[want_valid], want_flow[want_valid],
                               atol=TOL)


def _run(fn, img1, img2, params, **kw):
    flow, valid = fn(_t(img1), _t(img2), params, **kw)
    assert flow.dtype == torch.float32 and valid.dtype == torch.bool
    assert tuple(flow.shape) == img1.shape + (2,)
    return flow.numpy(), valid.numpy()


def test_prior_flow_matches_golden():
    img1, img2, _ = constant_flow_pair(48, 64, 2, -1, seed=3)
    prior = np.zeros(img1.shape + (2,), np.float32)
    prior[..., 0], prior[..., 1] = 1.75, -0.5
    kw = dict(BASE, levels=2, fb_backward="half", fb_grid="half")
    gold, gold_valid = gf.fsgm_flow(img1, img2, JaxFlowParams(**kw),
                                    prior_flow=prior.astype(np.float64))
    flow, valid = _run(flow_fsgm, img1, img2, FlowParams(**kw),
                       prior_flow=_t(prior))
    _assert_flow_close(flow, valid, gold, gold_valid)


def test_matches_frozen_fixture_flow_2lvl():
    fx = np.load(FIXDIR / "flow_2lvl.npz")
    flow, valid = _run(flow_fsgm, fx["img1"], fx["img2"],
                       FlowParams(search_radius=3, levels=2))
    _assert_flow_close(flow, valid, fx["flow"], fx["valid"])


def test_sequence_matches_frozen_fixture():
    fx = np.load(FIXDIR / "flow_seq_3frame.npz")
    flows, valids = flow_sequence(_t(fx["frames"]),
                                  FlowParams(search_radius=2, levels=2))
    assert tuple(flows.shape) == fx["flows"].shape
    for t in range(flows.shape[0]):
        _assert_flow_close(flows[t].numpy(), valids[t].numpy(),
                           fx["flows"][t], fx["valids"][t])


def test_sequence_with_track_params_matches_golden():
    frames, _ = constant_flow_sequence(40, 56, 3, 1, 3, seed=14)
    p = FlowParams(search_radius=2, levels=3)
    tp = dataclasses.replace(p, levels=2)
    gflows, gvalids = gf.flow_sequence(
        frames, JaxFlowParams(search_radius=2, levels=3),
        track_params=JaxFlowParams(search_radius=2, levels=2))
    flows, valids = flow_sequence(_t(frames), p, track_params=tp)
    for t in range(2):
        _assert_flow_close(flows[t].numpy(), valids[t].numpy(), gflows[t],
                           gvalids[t])


def test_matches_jax_xla_pipeline():
    img1, img2, _, _ = blockwise_flow_pair(40, 56, 3, seed=2)
    kw = dict(search_radius=2, levels=3, p1=7, p2=100, fb_backward="half",
              fb_grid="half")
    jf, jv = jax_flow_fsgm(jnp.asarray(img1), jnp.asarray(img2),
                           JaxFlowParams(**kw), "xla")
    flow, valid = _run(flow_fsgm, img1, img2, FlowParams(**kw))
    _assert_flow_close(flow, valid, np.asarray(jf), np.asarray(jv))


def test_kernel_path_equals_reference_on_cpu():
    img1, img2, _, _ = blockwise_flow_pair(37, 53, 3, seed=6)
    p = FlowParams(search_radius=2, levels=3, adaptive_p2=True,
                   fb_backward="half", fb_grid="half")
    _build.LAUNCHES.clear()
    flow, valid = _run(flow_fsgm, img1, img2, p)
    assert not _build.LAUNCHES          # CPU tensors launch no kernel
    ref, ref_valid = _run(flow_fsgm_reference, img1, img2, p)
    np.testing.assert_array_equal(valid, ref_valid)
    np.testing.assert_array_equal(flow, ref)


def test_batch_equals_per_frame():
    p = FlowParams(search_radius=2, levels=2)
    pairs = [blockwise_flow_pair(24, 40, 2, seed=k) for k in range(2)]
    imgs1 = _t(np.stack([a for a, _, _, _ in pairs]))
    imgs2 = _t(np.stack([b for _, b, _, _ in pairs]))
    flows, valids = flow_fsgm_batch(imgs1, imgs2, p)
    assert tuple(flows.shape) == (2, 24, 40, 2)
    for k in range(2):
        f, v = flow_fsgm(imgs1[k], imgs2[k], p)
        assert torch.equal(flows[k], f) and torch.equal(valids[k], v)


def test_mismatched_inputs_are_refused():
    a = torch.zeros((8, 12), dtype=torch.uint8)
    with pytest.raises(ValueError, match="equal"):
        flow_fsgm(a, a[:, :10], FlowParams(search_radius=1, levels=1))
    with pytest.raises(ValueError, match="equal"):
        flow_fsgm_batch(a[None], a[None, :, :10], FlowParams())
    with pytest.raises(ValueError, match="prior_flow"):
        flow_fsgm(a, a, FlowParams(search_radius=1, levels=1),
                  prior_flow=torch.zeros((8, 12)))
