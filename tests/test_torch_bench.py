"""PyTorch port: the bench (fsgm_tpu_torch/bench.py) against bench.py.

  * bench_params for the six cells, flow_label_pixels and the fb
    arguments equal bench.py's (its params and its FSGM_BENCH_FB /
    FSGM_BENCH_FBGRID overrides) field for field;
  * sgm_bytes_model equals PERF.md's kernel-table formulas;
  * a small run on the CPU prints exactly one stdout line with bench.py's
    keys and metric name, its stages, sustained mode and trace;
  * the guard passes against a loose best and exits 3 against a tight one;
  * the port's history covers every cell and names the card of each best.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench as jax_bench  # noqa: E402
from fsgm_tpu_torch import bench  # noqa: E402
from fsgm_tpu_torch.utils.profiling import (TRACE_FILE,  # noqa: E402
                                            sgm_bytes_model)

SMALL = dict(batch=2, shape=(48, 64))


def test_bench_params_equal_jax_for_every_cell():
    assert list(bench.CONFIGS) == list(jax_bench.CONFIGS)
    for cfg, row in bench.CONFIGS.items():
        assert row == jax_bench.CONFIGS[cfg]
        ours, want = bench.bench_params(cfg), jax_bench.bench_params(cfg)
        assert type(ours).__name__ == type(want).__name__
        assert dataclasses.asdict(ours) == dataclasses.asdict(want), cfg


def test_flow_label_pixels_equal_jax():
    for cfg in bench.FLOW_CELLS:
        h, w = bench.CONFIGS[cfg][:2]
        for fb in ("half", "single", "full"):
            ours = dataclasses.replace(bench.bench_params(cfg),
                                       fb_backward=fb)
            want = dataclasses.replace(jax_bench.bench_params(cfg),
                                       fb_backward=fb)
            assert (bench.flow_label_pixels(h, w, ours)
                    == jax_bench.flow_label_pixels(h, w, want)), (cfg, fb)


def test_fb_arguments_equal_jax_env_overrides(monkeypatch):
    for fb, grid in (("single", None), (None, "full"), ("cheap", "full")):
        for name, value in (("FSGM_BENCH_FB", fb),
                            ("FSGM_BENCH_FBGRID", grid)):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        for cfg in bench.FLOW_CELLS:
            ours = bench.bench_params(cfg, fb_backward=fb, fb_grid=grid)
            want = jax_bench.bench_params(cfg)
            assert dataclasses.asdict(ours) == dataclasses.asdict(want)


def test_bytes_model_is_the_kernel_table():
    h, w, d, b = 375, 1242, 128, 16
    hw, hwd = h * w, h * w * d
    k1 = b * (2 * hw * 8 + hw * d)
    k2 = b * (hwd + 1 * hw * 4 + 2 * hwd)      # a one-direction launch
    k3 = b * (2 * hwd + 5 * hw * 4)
    m = sgm_bytes_model(h, w, d, 8, 2, b)
    assert m == {"cost": k1, "aggregate": 8 * k2, "extract": k3,
                 "total": k1 + 8 * k2 + k3}
    # the plan of one KITTI frame: 6 vertical launches, the horizontal
    # pair in one family launch
    m1 = sgm_bytes_model(h, w, d, 8, 2, 1, [1] * 6 + [2])
    assert m1["aggregate"] == 7 * (hwd + 2 * hwd) + 8 * hw * 4
    with pytest.raises(ValueError):
        sgm_bytes_model(h, w, d, 8, 2, 1, [2, 2])


def test_small_run_prints_one_line_with_bench_keys(capsys, tmp_path):
    ctx = bench.run_config("tsukuba", "cpu", **SMALL, stages=True,
                           sustained=1, trace_dir=str(tmp_path))
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == "tsukuba_stereo_sgm_throughput"
    assert rec["unit"] == "Mpixel*disp/s" and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / bench.BASELINE_MPDS, 3)
    assert ctx["record"] == rec and ctx["batch"] == 2
    assert ctx["shape"] == [48, 64, 64] and len(ctx["ms_calls"]) == 6
    # no peak on the CPU: no vs_SoL and no share of a peak
    assert ctx["vs_SoL"] is None and ctx["peak_mib"] is None
    assert "# bench " in err and "# sustained: 1 queued" in err
    assert [r["stage"] for r in ctx["stages"]] == [
        "census_cost", "agg_down", "agg_up", "agg_cols", "extract"]
    assert all(r["bytes"] > 0 and r["pct_of_HBM_peak"] is None
               for r in ctx["stages"])
    assert (tmp_path / TRACE_FILE).stat().st_size > 0


def test_guard_passes_and_exits_3_on_a_regression(capsys, monkeypatch,
                                                  tmp_path):
    hist = tmp_path / "history.json"
    monkeypatch.setattr(bench, "HISTORY", hist)
    entry = {"tolerance": 0.1, "when": "test", "card": "test card"}
    hist.write_text(json.dumps({"configs": {"tsukuba": dict(
        entry, best_ms_frame=1e6)}}))
    ctx = bench.run_config("tsukuba", "cpu", **SMALL, guard=True)
    assert ctx["guard"] == "OK"
    assert "# guard: OK cfg=tsukuba" in capsys.readouterr().err
    hist.write_text(json.dumps({"configs": {"tsukuba": dict(
        entry, best_ms_frame=1e-6)}}))
    with pytest.raises(SystemExit) as e:
        bench.run_config("tsukuba", "cpu", **SMALL, guard=True)
    assert e.value.code == 3
    assert "# guard: REGRESSION cfg=tsukuba" in capsys.readouterr().err


def test_history_covers_every_cell_and_names_its_card():
    hist = json.loads(bench.HISTORY.read_text())["configs"]
    assert sorted(hist) == sorted(bench.CONFIGS)
    for cfg, entry in hist.items():
        assert entry["best_ms_frame"] > 0 and 0 < entry["tolerance"] < 1
        assert entry["when"] and entry["card"], cfg
        assert entry["power_limit"].endswith(" W"), cfg
