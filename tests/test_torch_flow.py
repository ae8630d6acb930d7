"""PyTorch port: fSGM flow end to end on the CPU, its CLI and its profiler.

  * flow_fsgm vs golden/flow.py::fsgm_flow for every fb_backward mode
    (full, cheap, single, half) on both fb_grid grids, with fb_check off,
    and with a temporal prior: validity planes equal, flow within 1e-3 on
    valid pixels (float32 vs golden's float64);
  * vs the frozen fixtures tests/fixtures/flow_2lvl.npz (flow_fsgm) and
    flow_seq_3frame.npz (flow_sequence), and vs JAX flow_fsgm(..., "xla");
  * flow_fsgm (padded label-major build, transposes, padded S) equal to
    flow_fsgm_reference (label-minor, unpadded) bit for bit on the CPU;
    flow_fsgm_batch equal to per-frame flow_fsgm;
  * the flow CLI with --device cpu, and --device cuda refused without a
    card; the profiler's flow breakdown adds up.
The kernels run on the card in the `cuda`-marked test at the end.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.flow as gf
from fsgm_tpu.io import kitti
from fsgm_tpu.io.images import save_gray
from fsgm_tpu.io.synthetic import (blockwise_flow_pair, constant_flow_pair,
                                   constant_flow_sequence)
from fsgm_tpu.models.flow import flow_fsgm as jax_flow_fsgm
from fsgm_tpu.params import FlowParams as JaxFlowParams
import fsgm_tpu_torch
from fsgm_tpu_torch import (FlowParams, flow_fsgm, flow_fsgm_batch,
                            flow_fsgm_reference, flow_sequence)
from fsgm_tpu_torch.cli.main import main as cli_main
from fsgm_tpu_torch.ops.kernels import _build
from fsgm_tpu_torch.utils.profiling import profile_flow

REPO = Path(__file__).resolve().parents[1]
FIXDIR = REPO / "tests" / "fixtures"
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


def test_prior_flow_matches_golden(pair):
    img1, img2 = pair
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


@pytest.mark.parametrize("suffix,fill", [(".png", False), (".flo", True)])
def test_cli_flow_on_cpu(tmp_path, capsys, suffix, fill):
    img1, img2, _, _ = blockwise_flow_pair(40, 56, 3, seed=1)
    save_gray(tmp_path / "a.png", img1)
    save_gray(tmp_path / "b.png", img2)
    out = tmp_path / f"f{suffix}"
    preset = REPO / "configs" / "kitti_flow.json"
    rc = cli_main(["flow", str(tmp_path / "a.png"), str(tmp_path / "b.png"),
                   "-o", str(out), "--preset", str(preset), "--device", "cpu"]
                  + (["--fill-invalid"] if fill else []))
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["cmd"] == "flow" and rec["out"] == str(out)
    p = fsgm_tpu_torch.load_preset(str(preset))["flow"]
    flow, valid = flow_fsgm(_t(img1), _t(img2), p)
    flow, valid = flow.numpy(), valid.numpy()
    assert rec["valid_frac"] == round(float(valid.mean()), 4)
    if suffix == ".flo":
        from fsgm_tpu.cli.main import densify_flow
        np.testing.assert_array_equal(kitti.read_flo(out),
                                      densify_flow(flow, valid))
        return
    got, got_valid = kitti.read_flow_png(out)
    np.testing.assert_array_equal(got_valid, valid)
    np.testing.assert_allclose(got[valid], flow[valid], atol=1 / 64)


def test_cli_flow_cuda_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="cuda"):
        cli_main(["flow", "a.png", "b.png", "-o", str(tmp_path / "f.png")])


def test_profile_flow_breakdown_adds_up_on_cpu():
    img1, img2, _, _ = blockwise_flow_pair(24, 40, 2, seed=3)
    p = FlowParams(search_radius=2, levels=2, fb_backward="half",
                   fb_grid="half")
    rec = profile_flow(_t(img1), _t(img2), p, calls=1, warmup=0)
    assert rec["device"] == "cpu" and rec["pipeline"] == "flow"
    assert rec["rows"] and all(r["ms"] > 0 for r in rec["rows"])
    assert sum(r["ms"] for r in rec["rows"]) == pytest.approx(rec["busy_ms"])
    assert rec["wall_ms"] > 0


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
    assert all(_build.LAUNCHES[k] > 0 for k in (
        "sgm_sweep", "extract_flow", "label_minor_from_major"))
    ref, ref_valid = flow_fsgm_reference(t1, t2, p)
    assert torch.equal(valid, ref_valid)
    assert float((flow - ref).abs().max()) <= TOL
    gold, gold_valid = gf.fsgm_flow(img1, img2, JaxFlowParams(**dataclasses
                                                              .asdict(p)))
    _assert_flow_close(flow.cpu().numpy(), valid.cpu().numpy(), gold,
                       gold_valid)
