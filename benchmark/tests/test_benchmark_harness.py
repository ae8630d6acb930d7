"""The harness: BENCHMARK.json within its contract, every file found by
its name, a run without a card, the result line's keys, and the trace
readings; one test drives a cell on the card (marked cuda)."""

import copy
import json
import re
import subprocess
import sys
import time
import types

import pytest
import torch

from benchmark import devtrace, harness, spec
from benchmark.tests.conftest import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def check_contract(b: dict) -> None:
    """Asserts that the benchmark ``b`` keeps its contract."""
    assert set(b) == TOP
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"]) and c["reduced"] == []
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert spec.load_config(c["name"])["source"] == c["source"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and _line(w["why"])
        assert w["chips"] in (1, 4), w
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4), \
        f"{four} four-card cells of {len(b['workloads'])}"
    assert len(pairs) == len(b["workloads"]) == len(set(cells()))
    assert {w["config"] for w in b["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e[
        "setup_s"]
    names = [m["name"] for g in ("end_to_end", "per_layer") for m in b[g]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells())
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:  # each such cell reports what it moves
            assert m["moves"] in (m2["name"] for m2 in
                                  spec.metrics_for(b, cell, False))
    for cell in cells():
        reported = {m["name"] for m in spec.metrics_for(b, cell, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_for(b, cell, True)
    assert len(json.dumps(b)) < 64 * 1024


def test_benchmark_json_keeps_its_contract():
    check_contract(spec.load_benchmark())


@pytest.mark.parametrize("beyond", [0, 1])
def test_the_contract_takes_one_four_card_cell_and_refuses_a_second(beyond):
    """max(1, cells // 4) cells may ask for 4 cards, and no more."""
    b = copy.deepcopy(spec.load_benchmark())
    allowed = max(1, len(b["workloads"]) // 4)
    for w in b["workloads"][:allowed + beyond]:
        w["chips"] = 4
    if not beyond:
        check_contract(b)
    else:
        with pytest.raises(AssertionError, match="four-card cells"):
            check_contract(b)


def test_every_name_loads_from_its_file():
    b = spec.load_benchmark()
    for w in b["workloads"]:
        cfg = spec.load_config(w["config"])
        traffic = spec.load_traffic(w["traffic"])
        driver = spec.load_driver(traffic["driver"])
        assert callable(driver.build) and driver.FRAME_AXIS in (True, False)
        assert callable(spec.load_generator(traffic["generator"]).make)
        assert callable(spec.load_reference(cfg["kind"]).run)
        assert set(spec.load_reference(cfg["kind"]).SMALL) == {
            "height", "width", "params"}
        assert callable(spec.load_work(cfg["kind"]).aggregate_work)
        assert cfg["limits"] == {"mismatched_px": 0}
        assert traffic["in_flight"] >= 1 and traffic["check_calls"] >= 1
    for g in ("end_to_end", "per_layer"):
        for m in b[g]:
            assert callable(spec.load_metric(m["name"]).read)
    for path in (spec.HERE / "traffic").glob("*.json"):  # cells to come too
        traffic = spec.load_traffic(path.stem)
        assert callable(spec.load_driver(traffic["driver"]).build)
        assert callable(spec.load_generator(traffic["generator"]).make)
    assert set(spec.kernel_stages().values()) >= {"aggregate", "cost",
                                                  "extract"}
    assert spec.peaks("NVIDIA H100 80GB HBM3")["bytes_per_s"] == 3.35e12


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "stereo_kitti.batch16", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True,
        cwd=spec.ROOT, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no result" in proc.stderr


def _stub_driver(kind: str, monkeypatch, **hooks) -> None:
    """spec.load_driver answering with a stub entry point that returns the
    reference's own outputs (and the driver functions ``hooks``)."""
    load_driver, ref = spec.load_driver, spec.load_reference(kind)

    def stub(name):
        frame_axis = load_driver(name).FRAME_AXIS

        def build(cfg):
            if frame_axis:
                return lambda a, b: ref.run(a, b, cfg)
            return lambda a, b: tuple(o[0] for o in ref.run(a[None], b[None],
                                                             cfg))
        return types.SimpleNamespace(FRAME_AXIS=frame_axis, build=build,
                                     **hooks)
    monkeypatch.setattr(spec, "load_driver", stub)


@pytest.mark.parametrize("cell", cells())
def test_result_line_keys_with_a_stub_driver(cell, small_cells,
                                             monkeypatch):
    """A stub entry point that answers with the reference's own outputs:
    the line holds the contract's keys, the cell's metrics, and the checks
    last."""
    b = spec.load_benchmark()
    kind = spec.load_config(spec.cell(b, cell)["config"])["kind"]
    _stub_driver(kind, monkeypatch)
    r = harness.run_cell(cell, 2 ** 31 + 1, 0.05, False, torch.device("cpu"),
                         time.perf_counter())
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    want = {m["name"]: m["unit"] for m in spec.metrics_for(b, cell, False)}
    assert {k: v["unit"] for k, v in r["metrics"].items()} == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["checks"] == {"mismatched_px": {"value": 0, "limit": 0}}
    json.dumps(r)


@pytest.mark.parametrize("peaks,count", [
    ((123_456_789, 5, 7, 9), 4), ((123_456_789, 0, 0, 0), 1)])
def test_a_multi_card_driver_is_closed_before_the_reference(
        peaks, count, small_cells, monkeypatch):
    """A driver's close runs once, after its peaks are read and before the
    reference; the line reports the largest peak and, as the count, the
    cards whose peak is above 0 (not the cell's chips)."""
    cell = cells()[0]
    bench = copy.deepcopy(spec.load_benchmark())
    spec.cell(bench, cell)["chips"] = 4
    monkeypatch.setattr(spec, "load_benchmark", lambda: bench)
    kind = spec.load_config(spec.cell(bench, cell)["config"])["kind"]
    seen = []

    def peak(call):
        seen.append("peak")
        return list(peaks)

    _stub_driver(kind, monkeypatch, memory_peak_bytes=peak,
                 close=lambda call: seen.append("close"))
    load_reference = spec.load_reference

    def reference(name):
        ref = load_reference(name)

        def run(*args, **kwargs):
            seen.append("reference")
            return ref.run(*args, **kwargs)
        return types.SimpleNamespace(run=run)
    monkeypatch.setattr(spec, "load_reference", reference)
    r = harness.run_cell(cell, 2 ** 31 + 11, 0.05, False,
                         torch.device("cpu"), time.perf_counter())
    assert seen == ["peak", "close", "reference"]
    assert r["correct"] is True
    assert r["device"]["count"] == count
    assert r["device"]["memory_peak_bytes"] == 123_456_789


@pytest.mark.parametrize("loader", ["load_reference", "load_metric"])
def test_a_forbidden_module_loaded_after_the_window_gives_no_result(
        loader, small_cells, monkeypatch):
    """JAX loaded by the reference or by a metric's reader, both after the
    window's own check, still stops the run before its result."""
    cell = cells()[0]
    kind = spec.load_config(spec.cell(spec.load_benchmark(), cell)[
        "config"])["kind"]
    _stub_driver(kind, monkeypatch)
    load = getattr(spec, loader)

    def loading_jax(name):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return load(name)
    monkeypatch.setattr(spec, loader, loading_jax)
    with pytest.raises(harness.ForbiddenModule, match="before the result"):
        harness.run_cell(cell, 2 ** 31 + 3, 0.05, False,
                         torch.device("cpu"), time.perf_counter())


def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_readings_of_a_known_trace():
    events = [
        _event("user_annotation", devtrace.WINDOW_SPAN, 0.0, 1000.0),
        _event("cpu_op", "aten::sort", 10.0, 40.0),
        _event("cuda_runtime", "cudaLaunchKernel", 20.0, 5.0, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 60.0, 5.0, corr=2),
        _event("kernel", "void at::native::bitonicSortKVInPlace<float>(int)",
               100.0, 300.0, tid=7, corr=1),
        _event("kernel", "void fsgm_k2::sgm_sweep_kernel<short, 4>(int)",
               350.0, 250.0, tid=7, corr=2),   # overlaps the sort
        _event("gpu_memset", "Memset (Device)", 900.0, 50.0, tid=7),
        _event("gpu_user_annotation", devtrace.WINDOW_SPAN, 0.0, 1000.0,
               tid=7)]
    stages = spec.kernel_stages()
    t = devtrace.Trace(events, 2, stages)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(550e-6)      # 100-600 and 900-950
    assert t.launches == 3
    assert t.kernel_s("aggregate") == pytest.approx(250e-6)
    assert t.kernel_s(None) == pytest.approx(300e-6)
    run = types.SimpleNamespace(
        trace=t, cfg=spec.load_config("kitti_stereo"), frames_per_call=1,
        peaks=spec.peaks("NVIDIA H100 80GB HBM3"), enqueue_s=[0.002, 0.004,
                                                              0.003],
        frames_done=40, window_s=0.05)
    read = {m: spec.load_metric(m).read(run) for m in (
        "device_idle_pct.batch", "launches_per_frame.stream",
        "plain_torch_ms.batch", "host_enqueue_ms.stream",
        "aggregate_roofline_pct.batch", "device_idle_pct.stream_untraced")}
    assert read["device_idle_pct.batch"] == pytest.approx(45.0)
    # 275 us busy a frame against 1.25 ms a frame of the window
    assert read["device_idle_pct.stream_untraced"] == pytest.approx(78.0)
    assert read["launches_per_frame.stream"] == 1.5
    assert read["plain_torch_ms.batch"] == pytest.approx(0.15)
    assert read["host_enqueue_ms.stream"] == pytest.approx(3.0)
    least = max(178_848_000 / 3.35e12, 3_815_424_000 / 6.69e13) * 2
    assert read["aggregate_roofline_pct.batch"] == pytest.approx(
        100 * least / 250e-6)
    run.peaks = None  # an unlisted card: nothing to read
    assert spec.load_metric("aggregate_roofline_pct.batch").read(run) is None
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["aten::sort > bitonicSortKVInPlace",
                                   pytest.approx(300e-6)]
    # 600-900 and 950-1000 inside the window span alone, 0-100 in the sort
    assert bd["idle_gaps"] == [[devtrace.WINDOW_SPAN, pytest.approx(350e-6)],
                               ["aten::sort", pytest.approx(100e-6)]]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "flow_kitti.stream", "--seed", str(2 ** 31 + 77), "--seconds",
         "1", "--trace", "1"], capture_output=True, text=True,
        cwd=spec.ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["busy_s"] > 0
    assert set(r["metrics"]) == {"device_idle_pct.stream",
                                 "device_idle_pct.stream_untraced",
                                 "launches_per_frame.stream",
                                 "host_enqueue_ms.stream"}
