"""PyTorch port: the batch / serve / demo / eval CLI and the stereo CLI's
lr_mode="reagg" and fill_invalid (the options themselves are tested in
test_torch_reagg.py).

  * the CLI on the CPU: stereo with --lr-mode / --fill-invalid, batch with
    --dispatch-batch, a --fault-inject run in a subprocess (exit 17) and
    the resume that skips the done frames, serve with every task,
    --pipeline, a malformed line and a failing write, a flow_batch request
    larger than one pass, demo and eval.
"""

import io as pyio
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fsgm_tpu.eval import metrics as jmetrics
from fsgm_tpu.io import kitti as jkitti
from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu_torch import SGMParams, io, stereo_sgm, stereo_sgm_batch
from fsgm_tpu_torch.cli.main import main as cli_main

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


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


def test_cli_serve_flow_batch_larger_than_one_pass(tmp_path, monkeypatch,
                                                  capsys):
    """A flow_batch request of more frames than the card's free memory
    holds in one pass runs in passes (chunk=None), each frame equal to
    per-frame flow_fsgm: the free memory is set to 2.5 frames' worth."""
    from fsgm_tpu_torch import FlowParams, flow_fsgm
    from fsgm_tpu_torch.models import flow as tflow
    h, w, n = 24, 32, 4
    fp = FlowParams(search_radius=2, levels=2)
    frame = h * w * fp.num_labels * tflow._FRAME_BYTES_PER_LABEL_PIXEL
    monkeypatch.setattr(tflow, "_free_bytes", lambda dev: frame * 5 // 2)
    passes = []
    flow_pass = tflow._flow

    def counted(imgs1, *args, **kw):
        passes.append(imgs1.shape[0])
        return flow_pass(imgs1, *args, **kw)

    monkeypatch.setattr(tflow, "_flow", counted)
    pairs, want = [], []
    for k in range(n):
        a, b, _ = io.constant_flow_pair(h, w, 1 + k % 2, -1, seed=40 + k)
        f1, f2 = tmp_path / f"a{k}.png", tmp_path / f"b{k}.png"
        io.save_gray(f1, a)
        io.save_gray(f2, b)
        pairs.append([str(f1), str(f2), str(tmp_path / f"o{k}.flo")])
        want.append(flow_fsgm(_t(a), _t(b), fp))
    passes.clear()
    out = _serve(monkeypatch, capsys,
                 [{"task": "flow_batch", "id": "fb", "pairs": pairs}],
                 "--search-radius", "2", "--levels", "2")
    assert passes == [2, 2] and out[-1] == {"served": 1}
    assert out[1]["outs"] == [q[2] for q in pairs]
    for (_, _, o), (f, v), vf in zip(pairs, want, out[1]["valid_frac"]):
        want_flo = np.where(v.numpy()[..., None], f.numpy(), 0)
        np.testing.assert_array_equal(io.read_flo(o), want_flo)
        assert vf == round(float(v.numpy().mean()), 4)


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
