"""PyTorch port: fSGM flow's batched launch sets on the CPU.

  * flow_fsgm_batch over B = 3 frames, with chunk 1, 2 (rounded down to 1)
    and None, equal bit for bit to per-frame flow_fsgm_reference (the plain
    versions, the two directions of a level one after the other) in every
    fb_backward x fb_grid mode;
  * flow_fsgm_batch vs JAX fsgm_tpu.models.flow.flow_fsgm_batch(...,
    backend="xla", chunk=B) at config 4's modes (half / half): validity
    planes equal, flow within 1e-3;
  * the lockstep level (_flow_level_pair) equal to two sequential level
    calls, also where extraction splits (the last level of "cheap");
  * the frame axis of the flow cost build, the pyramid and resampling,
    fb_check, and the K4 and K5 wrappers on (N, ...) CPU tensors, equal to
    the per-frame results;
  * `profiling --pipeline flow --batch B` (profile_flow) over B frames;
  * the refusals (mismatched shapes, chunk < 1, 5-D volumes);
  * on the card (`cuda`, skipped here): K4 and K5 on (N, ...) volumes, one
    launch each, equal to their plain versions.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsgm_tpu.models.flow import flow_fsgm_batch as jax_flow_fsgm_batch
from fsgm_tpu.params import FlowParams as JaxFlowParams
from fsgm_tpu_torch import (FlowParams, flow_fsgm, flow_fsgm_batch,
                            flow_fsgm_reference)
from fsgm_tpu_torch.io import blockwise_flow_pair
from fsgm_tpu_torch.models import flow as tflow
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.cost import cost_volume_flow, cost_volume_flow_major
from fsgm_tpu_torch.ops.kernels import _build, extract, transpose
from fsgm_tpu_torch.utils import profiling

TOL = 1e-3
B = 3
P = FlowParams(search_radius=2, levels=3, p1=7, p2=60)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the cores, and these
    tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(h, w, seeds):
    got = [blockwise_flow_pair(h, w, 3, seed=s)[:2] for s in seeds]
    return (torch.from_numpy(np.stack([g[0] for g in got])),
            torch.from_numpy(np.stack([g[1] for g in got])))


@pytest.fixture(scope="module")
def frames():
    return _frames(32, 48, range(10, 10 + B))


@pytest.mark.parametrize("fb_backward", ["full", "cheap", "single", "half"])
def test_batch_equals_per_frame_reference(frames, fb_backward):
    i1, i2 = frames
    for fb_grid in ("full", "half"):
        p = dataclasses.replace(P, fb_backward=fb_backward, fb_grid=fb_grid)
        want = [flow_fsgm_reference(a, b, p) for a, b in zip(i1, i2)]
        for chunk in (1, 2, None):
            flows, valids = flow_fsgm_batch(i1, i2, p, chunk=chunk)
            assert flows.shape == (B, 32, 48, 2) and valids.shape == (B, 32,
                                                                      48)
            for k, (f, v) in enumerate(want):
                assert torch.equal(flows[k], f) and torch.equal(valids[k], v)
        assert valids.any() and not valids.all()


def test_batch_matches_jax_flow_fsgm_batch():
    i1, i2 = _frames(32, 48, (2, 3))
    kw = dict(search_radius=2, levels=2, p1=7, p2=100, fb_backward="half",
              fb_grid="half")
    jf, jv = jax_flow_fsgm_batch(jnp.asarray(i1.numpy()),
                                 jnp.asarray(i2.numpy()),
                                 JaxFlowParams(**kw), backend="xla", chunk=2)
    flows, valids = flow_fsgm_batch(i1, i2, FlowParams(**kw))
    jf, jv = np.asarray(jf), np.asarray(jv)
    assert jv.any() and not jv.all()
    np.testing.assert_array_equal(valids.numpy(), jv)
    np.testing.assert_allclose(flows.numpy()[jv], jf[jv], atol=TOL)


def test_level_pair_equals_two_level_calls(frames):
    """_flow_level_pair over 2B slices against the forward and the backward
    level one after the other (the kernel wrappers' plain versions), with
    equal params (extraction over both halves) and with the last level of
    "cheap" (extraction split)."""
    i1, i2 = frames
    c1 = census_transform(i1, P.census_window)
    c2 = census_transform(i2, P.census_window)
    rng = np.random.default_rng(5)
    prior_f, prior_b = (torch.from_numpy(rng.uniform(
        -2.5, 2.5, (B, 32, 48, 2)).astype(np.float32)) for _ in range(2))
    cheap = dataclasses.replace(P, subpixel=False, median_filter=False)
    for bp in (P, cheap):
        got_f, got_b = tflow._flow_level_pair(i1, i2, c1, c2, prior_f,
                                              prior_b, P, bp)
        want_f = tflow._flow_one_level(i1, c1, c2, prior_f, P, plain=False)
        want_b = tflow._flow_one_level(i2, c2, c1, prior_b, bp, plain=False)
        assert torch.equal(got_f, want_f) and torch.equal(got_b, want_b)
        ref_b = tflow._flow_one_level(i2[1], c2[1], c1[1], prior_b[1], bp,
                                      plain=True)
        assert torch.equal(got_b[1], ref_b)


def test_frame_axis_ops_equal_per_frame(frames):
    """The cost build (label-minor and label-major, padded), the pyramid,
    the flow resampling, fb_check, K5 and K4 over N slices against each
    slice alone."""
    i1, i2 = frames
    r, nl, e = P.search_radius, P.num_labels, P.window_extent
    c1, c2 = census_transform(i1, P.census_window), census_transform(
        i2, P.census_window)
    rng = np.random.default_rng(7)
    bu, bv = (torch.from_numpy(rng.integers(-3, 4, (B, 32, 48),
                                            dtype=np.int32)) for _ in "uv")
    minor = cost_volume_flow(c1, c2, bu, bv, r)
    major = cost_volume_flow_major(c1, c2, bu, bv, r, nl_pad=32)
    assert major.shape == (B, 32, 32, 48)
    vol = torch.from_numpy(rng.integers(0, 256, (B, 7, 48, 21),
                                        dtype=np.uint8))
    k5 = transpose.label_minor_from_major(vol)
    s = torch.from_numpy(rng.integers(0, 2000, (B, 32, 48, 32),
                                      dtype=np.int16))
    k4 = extract.extract_flow(s, nl, e)
    flow = torch.from_numpy(rng.uniform(-4, 4, (B, 31, 47, 2))
                            .astype(np.float32))
    down = tflow.downsample_flow_2x(flow)
    up = tflow.upsample_flow_2x(down, 31, 47)
    valid = tflow.upsample_valid_2x(down[..., 0] > 0, 31, 47)
    fb = tflow.fb_check(flow, flow.flip(0), 1.0)
    pyr = tflow.build_pyramid(i1, 3)
    for n in range(B):
        assert torch.equal(minor[n], cost_volume_flow(c1[n], c2[n], bu[n],
                                                      bv[n], r))
        assert torch.equal(major[n], cost_volume_flow_major(
            c1[n], c2[n], bu[n], bv[n], r, nl_pad=32))
        assert torch.equal(k5[n],
                           transpose.label_minor_from_major_plain(vol[n]))
        want = extract.extract_flow_plain(s[n], nl, e)
        assert torch.equal(k4[0][n], want[0])
        for got3, want3 in zip(k4[1] + k4[2], want[1] + want[2]):
            assert torch.equal(got3[n], want3)
        assert torch.equal(down[n], tflow.downsample_flow_2x(flow[n]))
        assert torch.equal(up[n], tflow.upsample_flow_2x(down[n], 31, 47))
        assert torch.equal(valid[n], tflow.upsample_valid_2x(
            down[n, ..., 0] > 0, 31, 47))
        assert torch.equal(fb[n], tflow.fb_check(flow[n], flow[B - 1 - n],
                                                 1.0))
        for lvl, img in zip(pyr, tflow.build_pyramid(i1[n], 3)):
            assert torch.equal(lvl[n], img)
    assert minor.permute(0, 1, 3, 2).equal(major[:, :, :nl])


def test_profiling_cli_takes_a_flow_batch(capsys, tmp_path):
    preset = tmp_path / "flow.json"
    preset.write_text(json.dumps({"flow": {
        "__class__": "FlowParams", "search_radius": 1, "levels": 2,
        "fb_backward": "half", "fb_grid": "half"}}))
    assert profiling.main(["--pipeline", "flow", "--batch", "2", "--device",
                           "cpu", "--height", "16", "--width", "24",
                           "--preset", str(preset), "--calls", "1",
                           "--warmup", "0"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["pipeline"] == "flow" and rec["batch"] == 2
    assert rec["frames_per_call"] == 2 and rec["shape"] == [16, 24, 9]
    assert sum(r["ms"] for r in rec["rows"]) == pytest.approx(rec["busy_ms"])
    with pytest.raises(SystemExit, match="B >= 1"):
        profiling.main(["--pipeline", "flow", "--batch", "0", "--device",
                        "cpu"])


def test_refusals(frames):
    i1, i2 = frames
    with pytest.raises(ValueError, match="equal"):
        flow_fsgm_batch(i1, i2[:, :, :40], P)
    with pytest.raises(ValueError, match="equal"):
        flow_fsgm_batch(i1[0], i2[0], P)
    with pytest.raises(ValueError, match="equal"):
        flow_fsgm_batch(i1[:0], i2[:0], P)
    with pytest.raises(ValueError, match="equal"):
        flow_fsgm(i1, i2, P)
    for chunk in (0, -1):
        with pytest.raises(ValueError, match="chunk"):
            flow_fsgm_batch(i1, i2, P, chunk=chunk)
    with pytest.raises(TypeError, match="uint8"):
        transpose.label_minor_from_major(
            torch.zeros((1, 2, 3, 16, 8), dtype=torch.uint8))
    with pytest.raises(TypeError, match="int16"):
        extract.extract_flow(torch.zeros((1, 2, 3, 4, 32),
                                         dtype=torch.int16), 25, 5)
    with pytest.raises(ValueError, match="slice counts"):
        cost_volume_flow_major(*(torch.zeros((2, 8, 8), dtype=torch.int64)
                                 for _ in range(2)),
                               *(torch.zeros((1, 8, 8), dtype=torch.int32)
                                 for _ in range(2)), 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k4_k5_frame_axis_on_the_card(card):
    gen = torch.Generator(device=card).manual_seed(0)
    vol = torch.randint(0, 256, (5, 46, 96, 155), generator=gen,
                        device=card, dtype=torch.uint8)
    s = torch.randint(0, 20000, (5, 46, 155, 96), generator=gen,
                      device=card, dtype=torch.int32).to(torch.int16)
    _build.LAUNCHES.clear()
    got5 = transpose.label_minor_from_major(vol)
    got4 = extract.extract_flow(s, 81, 9)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["label_minor_from_major"] == 1
    assert _build.LAUNCHES["extract_flow"] == 1
    assert torch.equal(got5, transpose.label_minor_from_major_plain(vol))
    want4 = extract.extract_flow_plain(s, 81, 9)
    for g, w in zip((got4[0],) + got4[1] + got4[2],
                    (want4[0],) + want4[1] + want4[2]):
        assert torch.equal(g, w)
