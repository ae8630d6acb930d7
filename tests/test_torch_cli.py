"""PyTorch port: the stereo and flow CLI and the profiler on the CPU.

  * `stereo` and `flow` with --device cpu on PNGs: the written disparity
    (KITTI 16-bit PNG, 1/256 steps) and flow (.png in 1/64 steps, or .flo
    with --fill-invalid, densified as the JAX package's CLI does) equal
    stereo_sgm / flow_fsgm, and the JSON record's valid share matches;
  * --device cuda is refused without a card;
  * the profiler's stereo breakdown adds up, for one frame and per frame
    of a batch, and so does its flow breakdown.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fsgm_tpu.io import kitti
from fsgm_tpu.io.images import save_gray
from fsgm_tpu.io.synthetic import blockwise_flow_pair, random_dot_stereo
import fsgm_tpu_torch
from fsgm_tpu_torch import FlowParams, SGMParams, flow_fsgm, stereo_sgm
from fsgm_tpu_torch.cli.main import main as cli_main
from fsgm_tpu_torch.utils.profiling import profile_flow, profile_stereo

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_cli_stereo_on_cpu(tmp_path, capsys):
    il, ir, _ = random_dot_stereo(24, 40, 16, seed=2)
    save_gray(tmp_path / "l.png", il)
    save_gray(tmp_path / "r.png", ir)
    out = tmp_path / "d.png"
    rc = cli_main(["stereo", str(tmp_path / "l.png"),
                   str(tmp_path / "r.png"), "-o", str(out),
                   "--preset", str(REPO / "configs" / "kitti_stereo.json"),
                   "--device", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["cmd"] == "stereo" and (rec["h"], rec["w"], rec["d"]) == (
        24, 40, 128)
    p = fsgm_tpu_torch.load_preset(str(REPO / "configs" /
                                       "kitti_stereo.json"))["sgm"]
    want = stereo_sgm(_t(il), _t(ir), p).numpy()
    got = kitti.read_disparity_png(out)
    np.testing.assert_allclose(got[want >= 0], want[want >= 0],
                               atol=1 / 256)
    assert rec["valid_frac"] == round(float((want >= 0).mean()), 4)


def test_cli_cuda_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="cuda"):
        cli_main(["stereo", "l.png", "r.png", "-o", str(tmp_path / "d.png"),
                  "--max-disp", "16"])


def test_profile_breakdown_adds_up_on_cpu():
    il, ir, _ = random_dot_stereo(16, 24, 16, seed=3)
    rec = profile_stereo(_t(il), _t(ir), SGMParams(max_disp=16), calls=1,
                         warmup=0)
    assert rec["device"] == "cpu" and rec["peak_mib"] is None
    assert rec["batch"] == 1 and rec["shape"] == [16, 24, 16]
    batch = profile_stereo(_t(np.stack([il, il])), _t(np.stack([ir, ir])),
                           SGMParams(max_disp=16), calls=1, warmup=0)
    assert batch["batch"] == 2 and batch["frames_per_call"] == 2
    assert batch["launches"] == pytest.approx(
        sum(r["launches"] for r in batch["rows"]))
    assert rec["rows"] and all(r["ms"] > 0 for r in rec["rows"])
    assert sum(r["ms"] for r in rec["rows"]) == pytest.approx(rec["busy_ms"])
    assert sum(r["share"] for r in rec["rows"]) == pytest.approx(1.0)
    assert rec["wall_ms"] > 0 and rec["busy_share"] > 0


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
