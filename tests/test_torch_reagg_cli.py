"""PyTorch port: lr_mode="reagg", fill_invalid and the batch / serve / demo
/ eval CLI.

  * stereo_sgm with lr_mode="reagg" and fill_invalid=True against JAX
    stereo_sgm(..., "pallas_tr") (interpret mode); each option alone
    against golden/sgm.py::sgm_stereo and the frozen reagg fixture;
    invalid masks identical, disparities within 1e-3;
  * right_disparity_reagg against golden's right-reference SGM and WTA
    (exact integers), interpolate_invalid against fsgm_tpu/ops/extract.py
    and golden (exact), lr_check with max_disp against the JAX rule;
  * the CLI on the CPU: stereo with --lr-mode / --fill-invalid, batch with
    --dispatch-batch, a --fault-inject run in a subprocess (exit 17) and
    the resume that skips the done frames, serve with every task,
    --pipeline, a malformed line and a failing write, demo and eval.
"""

import io as pyio
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.sgm as g
from fsgm_tpu.eval import metrics as jmetrics
from fsgm_tpu.io import kitti as jkitti
from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu.models import stereo as jstereo
from fsgm_tpu.ops import extract as jext
from fsgm_tpu_torch import SGMParams, io, stereo_sgm, stereo_sgm_batch
from fsgm_tpu_torch.cli.main import main as cli_main
from fsgm_tpu_torch.models.stereo import right_disparity_reagg
from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.census import census_transform

REPO = Path(__file__).resolve().parents[1]
FIXDIR = REPO / "tests" / "fixtures"
TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_disp_close(ours, want):
    np.testing.assert_array_equal(ours < 0, want < 0)
    both = ours >= 0
    np.testing.assert_allclose(ours[both], want[both], atol=TOL)


def test_reagg_and_fill_match_jax_pallas_tr():
    il, ir, _ = random_dot_stereo(37, 53, 16, seed=21)
    p = SGMParams(max_disp=16, p1=7, p2=60, lr_mode="reagg",
                  fill_invalid=True)
    want = np.asarray(jstereo.stereo_sgm(jnp.asarray(il), jnp.asarray(ir),
                                         p, "pallas_tr"))
    ours = stereo_sgm(_t(il), _t(ir), p).numpy()
    _assert_disp_close(ours, want)
    _assert_disp_close(ours, g.sgm_stereo(il, ir, p))


@pytest.mark.parametrize("kw", [dict(lr_mode="reagg"),
                                dict(fill_invalid=True),
                                dict(lr_mode="reagg", num_paths=16,
                                     adaptive_p2=True, subpixel=False)])
def test_options_match_golden(kw):
    il, ir, _ = random_dot_stereo(30, 44, 16, seed=22)
    p = SGMParams(max_disp=16, p1=7, p2=60, **kw)
    _assert_disp_close(stereo_sgm(_t(il), _t(ir), p).numpy(),
                       g.sgm_stereo(il, ir, p))


def test_reagg_matches_frozen_fixture():
    fx = np.load(FIXDIR / "stereo_reagg.npz")
    p = SGMParams(max_disp=32, p1=7, p2=60, lr_mode="reagg")
    _assert_disp_close(stereo_sgm(_t(fx["img_l"]), _t(fx["img_r"]),
                                  p).numpy(), fx["disp"])


def test_right_disparity_matches_golden():
    il, ir, _ = random_dot_stereo(29, 41, 16, seed=23)
    p = SGMParams(max_disp=16, p1=7, p2=60, adaptive_p2=True)
    cost_r = g.cost_volume_stereo_right(g.census_transform(il),
                                        g.census_transform(ir), 16, 255)
    want = g.wta(g.aggregate_paths(cost_r, ir, p))
    ours = right_disparity_reagg(census_transform(_t(il))[None],
                                 census_transform(_t(ir))[None],
                                 _t(ir)[None], p)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours[0].numpy(), want)


def _holey_field(shape, seed):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0, 60, shape).astype(np.float32)
    f[rng.random(shape) < 0.4] = -1.0
    f[..., 0, :] = -1.0                      # a row with no valid pixel
    f[..., 1, :3] = -1.0                     # leading invalid run
    f[..., 2, -4:] = -1.0                    # trailing invalid run
    return f


@pytest.mark.parametrize("shape", [(5, 1), (6, 40)])
def test_interpolate_invalid_matches_jax_and_golden(shape):
    f = _holey_field(shape, shape[1])
    ours = ext.interpolate_invalid(_t(f)).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jext.interpolate_invalid(jnp.asarray(f))))
    np.testing.assert_array_equal(ours, g.interpolate_invalid(f))
    batch = _holey_field((3,) + shape, 5)
    got = ext.interpolate_invalid(_t(batch)).numpy()
    for k in range(3):
        np.testing.assert_array_equal(got[k], g.interpolate_invalid(batch[k]))


def test_lr_check_with_max_disp_matches_jax():
    rng = np.random.default_rng(24)
    d_left = rng.uniform(-1.4, 20.0, (9, 30)).astype(np.float32)
    d_left[0, :4] = [0.5, 1.5, 2.5, -0.5]     # rint ties go to even
    d_right = rng.integers(0, 20, (9, 30)).astype(np.int32)
    want = np.asarray(jext.lr_check(jnp.asarray(d_left),
                                    jnp.asarray(d_right), 1, 12))
    np.testing.assert_array_equal(
        ext.lr_check(_t(d_left), _t(d_right), 1, 12).numpy(), want)


def _write_pairs(tmp_path, shapes, d=16):
    """PNG pairs of the given shapes; lines 'left right out' per pair."""
    lines = []
    for k, (h, w) in enumerate(shapes):
        il, ir, _ = random_dot_stereo(h, w, d, seed=30 + k)
        io.save_gray(tmp_path / f"l{k}.png", il)
        io.save_gray(tmp_path / f"r{k}.png", ir)
        lines.append((str(tmp_path / f"l{k}.png"), str(tmp_path / f"r{k}.png"),
                      str(tmp_path / f"d{k}.png")))
    return lines


def _disp_of(line, p):
    return stereo_sgm(_t(io.load_gray(line[0])), _t(io.load_gray(line[1])),
                      p).numpy()


def _assert_png_is(path, want):
    got = io.read_disparity_png(path)
    np.testing.assert_array_equal(got < 0, want < 0)
    np.testing.assert_allclose(got[want >= 0], want[want >= 0], atol=1 / 256)


def test_cli_stereo_lr_mode_and_fill_on_cpu(tmp_path, capsys):
    line = _write_pairs(tmp_path, [(24, 40)])[0]
    rc = cli_main(["stereo", line[0], line[1], "-o", line[2], "--max-disp",
                   "16", "--p2", "60", "--lr-mode", "reagg",
                   "--fill-invalid", "--device", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _disp_of(line, SGMParams(max_disp=16, p2=60, lr_mode="reagg",
                                    fill_invalid=True))
    _assert_png_is(line[2], want)
    assert rec["valid_frac"] == round(float((want >= 0).mean()), 4)


def test_cli_batch_fault_inject_then_resume(tmp_path, capsys):
    lines = _write_pairs(tmp_path, [(24, 40)] * 3 + [(20, 32)] * 2)
    lst = tmp_path / "pairs.txt"
    lst.write_text("\n".join("\t".join(x) for x in lines) + "\n")
    manifest = tmp_path / "run.jsonl"
    args = ["batch", str(lst), "--manifest", str(manifest), "--max-disp",
            "16", "--p2", "60", "--dispatch-batch", "2", "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-m", "fsgm_tpu_torch.cli", *args,
                           "--fault-inject", "2"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 17, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "cmd": "batch", "fault_injected": True, "done": 2}
    assert [Path(x[2]).exists() for x in lines] == [True, True, False,
                                                    False, False]
    assert len(manifest.read_text().splitlines()) == 2
    assert cli_main(args) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "cmd": "batch", "total": 5, "newly_done": 3, "skipped": 2}
    p = SGMParams(max_disp=16, p2=60)
    for line in lines:
        _assert_png_is(line[2], _disp_of(line, p))
    assert len(manifest.read_text().splitlines()) == 5


def _serve(monkeypatch, capsys, requests, *flags):
    text = "".join(r if isinstance(r, str) else json.dumps(r) + "\n"
                   for r in requests)
    monkeypatch.setattr(sys, "stdin", pyio.StringIO(text + "\n"))
    assert cli_main(["serve", "--device", "cpu", *flags]) == 0
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def test_cli_serve_every_task_on_cpu(tmp_path, monkeypatch, capsys):
    lines = _write_pairs(tmp_path, [(24, 40)] * 3)
    f1, f2 = (str(tmp_path / n) for n in ("f1.png", "f2.png"))
    flow_a, flow_b, _ = io.constant_flow_pair(24, 32, 1, -1, seed=3)
    io.save_gray(f1, flow_a)
    io.save_gray(f2, flow_b)
    reqs = [
        {"task": "stereo", "id": "s", "left": lines[0][0],
         "right": lines[0][1], "out": lines[0][2]},
        "{not json\n",
        {"task": "stereo_batch", "id": "sb",
         "pairs": [list(lines[1]), list(lines[2])]},
        {"task": "flow", "id": "f", "first": f1, "second": f2,
         "out": str(tmp_path / "f.flo")},
        {"task": "stereo", "id": "bad_out", "left": lines[0][0],
         "right": lines[0][1], "out": str(tmp_path / "none" / "d.png")},
        {"task": "flow_batch", "id": "fb",
         "pairs": [[f1, f2, str(tmp_path / "fb.png")]]},
    ]
    out = _serve(monkeypatch, capsys, reqs, "--max-disp", "16", "--p2", "60",
                 "--search-radius", "2", "--levels", "2", "--pipeline", "2")
    assert out[0] == {"serving": True, "device": "cpu"}
    assert out[-1] == {"served": 6}
    resp = out[1:-1]
    assert [r.get("id") for r in resp] == ["s", 1, "sb", "f", "bad_out",
                                           "fb"]
    assert "error" in resp[1] and resp[1]["out"] is None
    assert "error" in resp[4] and resp[4]["out"].endswith("d.png")
    assert all("wall_s" in r for r in resp)
    p = SGMParams(max_disp=16, p2=60)
    for line in lines:
        _assert_png_is(line[2], _disp_of(line, p))
    assert resp[2]["outs"] == [lines[1][2], lines[2][2]]
    want = stereo_sgm_batch(_t(np.stack([io.load_gray(x[0])
                                         for x in lines[1:]])),
                            _t(np.stack([io.load_gray(x[1])
                                         for x in lines[1:]])), p).numpy()
    assert resp[2]["density"] == [round(float((d >= 0).mean()), 4)
                                  for d in want]
    assert (tmp_path / "f.flo").exists() and (tmp_path / "fb.png").exists()
    assert 0 < resp[3]["valid_frac"] <= 1 and len(resp[5]["valid_frac"]) == 1


def test_cli_serve_refuses_a_preset_without_parameters(tmp_path):
    preset = tmp_path / "empty.json"
    preset.write_text(json.dumps({"description": "no parameters"}))
    with pytest.raises(SystemExit, match="neither"):
        cli_main(["serve", "--device", "cpu", "--preset", str(preset)])


def test_cli_demo_and_eval_on_cpu(tmp_path, capsys):
    assert cli_main(["demo", "--device", "cpu"]) == 0
    demo = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["demo"] for r in demo] == ["stereo", "flow"]
    assert demo[0]["d1_all"] < 0.2 and demo[1]["fl_all"] < 0.2
    rng = np.random.default_rng(25)
    gt = np.where(rng.random((12, 17)) < 0.8, rng.uniform(1, 60, (12, 17)),
                  -1).astype(np.float32)
    pred = np.where(gt > 0, gt + rng.normal(0, 4, gt.shape), -1)
    flow = rng.normal(0, 5, (12, 17, 2)).astype(np.float32)
    valid = rng.random((12, 17)) < 0.7
    io.write_disparity_png(tmp_path / "gt.png", gt)
    io.write_disparity_png(tmp_path / "pred.png", pred)
    io.write_flow_png(tmp_path / "fgt.png", flow, valid)
    io.write_flow_png(tmp_path / "fpred.png", flow + 2.5, valid)
    for task, pr, gt_png in (("stereo", "pred.png", "gt.png"),
                             ("flow", "fpred.png", "fgt.png")):
        assert cli_main(["eval", task, str(tmp_path / pr),
                         str(tmp_path / gt_png)]) == 0
        got = json.loads(capsys.readouterr().out.strip())
        if task == "stereo":
            jgt = jkitti.read_disparity_png(tmp_path / gt_png)
            want = jmetrics.d1_all(jkitti.read_disparity_png(tmp_path / pr),
                                   jgt, jgt > 0)
        else:
            fp, fpv = jkitti.read_flow_png(tmp_path / pr)
            fg, fgv = jkitti.read_flow_png(tmp_path / gt_png)
            want = jmetrics.fl_all(fp, fg, fgv, pred_valid=fpv)
        assert got == want


def test_png_readers_read_what_the_reference_reads(tmp_path):
    rng = np.random.default_rng(26)
    disp = np.where(rng.random((9, 13)) < 0.7,
                    rng.uniform(0, 90, (9, 13)), -1).astype(np.float32)
    flow = rng.normal(0, 9, (9, 13, 2)).astype(np.float32)
    valid = rng.random((9, 13)) < 0.6
    jkitti.write_disparity_png(tmp_path / "d.png", disp)
    jkitti.write_flow_png(tmp_path / "f.png", flow, valid)
    np.testing.assert_array_equal(io.read_disparity_png(tmp_path / "d.png"),
                                  jkitti.read_disparity_png(tmp_path /
                                                            "d.png"))
    for a, b in zip(io.read_flow_png(tmp_path / "f.png"),
                    jkitti.read_flow_png(tmp_path / "f.png")):
        np.testing.assert_array_equal(a, b)
