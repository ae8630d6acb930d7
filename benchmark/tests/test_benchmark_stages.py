"""benchmark/stages.py on a synthetic lean trace and synthetic program
records: device work and launches go to the innermost span open at the
launch, idle gaps to the span open at their middle, the eight metrics read
it, and nothing is read where the records miss the trace."""

import dataclasses
import types

import pytest

from benchmark import devtrace, spec, stages
from fsgm_tpu_torch.utils import tracing

BASE = tracing.trace_base_ns(1_790_000_000 * 10 ** 9)


def _trace(launches, frames=2, kernel_stages=None):
    """A lean trace: for each (launch us, start us, dur us) a runtime call
    of 5 us and a kernel, correlated; the window is the runtime calls'."""
    events = []
    for k, (at, start, dur) in enumerate(launches):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": at, "dur": 5,
                       "args": {"correlation": k}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{k}",
                       "ts": start, "dur": dur, "args": {"correlation": k}})
    return devtrace.Trace(events, frames, kernel_stages or {})


def _rec(k, name, parent, t0_us, t1_us):
    return tracing.Record(k, name, parent, BASE + int(t0_us * 1e3),
                          BASE + int(t1_us * 1e3))


RECS = [_rec(0, "fsgm.flow", None, 0, 100),
        _rec(1, "fsgm.census", 0, 10, 30),
        _rec(2, "fsgm.level", 0, 40, 90),
        _rec(3, "fsgm.cost", 2, 45, 60),
        _rec(4, "fsgm.median", 2, 70, 80)]
# (launch us, device start us, device us): census twice, the cost, the
# level itself, the median
LAUNCHES = [(12, 14, 4), (25, 27, 2), (50, 52, 6), (62, 63, 2),
            (72, 73, 2)]


@pytest.fixture
def program(monkeypatch):
    recs = list(RECS)
    monkeypatch.setattr(stages, "_records", lambda: (recs, tracing.trace_us))
    return recs


def test_device_work_and_gaps_go_to_the_innermost_span(program):
    got = stages.of(types.SimpleNamespace(trace=_trace(LAUNCHES)))
    assert got.launches == {"fsgm.census": 2, "fsgm.cost": 1,
                            "fsgm.level": 1, "fsgm.median": 1}
    assert got.ms("fsgm.census") == pytest.approx(6e-3 / 2)
    assert got.ms("fsgm.cost") == pytest.approx(6e-3 / 2)
    assert got.outside_ms() == pytest.approx(2e-3 / 2)
    # the window runs from the first runtime call (12) to the last's end
    # (77): gaps 12-14 and 18-27 (census), 29-52 (middle 40.5: the level,
    # before the cost span), 58-63 and 65-73 (the level), 75-77 (median)
    assert dict(got.idle_s) == pytest.approx(
        {"fsgm.census": 11e-6, "fsgm.level": 36e-6, "fsgm.median": 2e-6})


def test_the_eight_metrics_read_it(program):
    run = types.SimpleNamespace(trace=_trace(LAUNCHES))
    want = {"census_ms.batch": 3e-3, "cost_ms.batch": 3e-3,
            "median_ms.batch": 1e-3, "outside_stages_ms.batch": 1e-3,
            "census_launches.stream": 1.0, "cost_launches.stream": 0.5,
            "census_idle_ms.stream": 5.5e-3, "cost_idle_ms.stream": 0.0}
    got = {name: spec.load_metric(name).read(run) for name in want}
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "frames_per_s", "aggregate_roofline_pct", "plain_torch_ms",
    "device_idle_pct", "census_ms", "cost_ms", "median_ms",
    "outside_stages_ms"])
def test_the_flow_batch_metrics_read_as_the_batch_ones(program, name):
    """Each metric of the batched flow cells reads what its counterpart of
    the stereo batch cell reads (frames_per_s, or the .batch metric)."""
    run = types.SimpleNamespace(
        trace=_trace(LAUNCHES, kernel_stages={"k2": "aggregate"}),
        cfg=spec.load_config("kitti_flow"), frames_done=40, window_s=0.05,
        peaks=spec.peaks("NVIDIA H100 80GB HBM3"))
    batch = name if name == "frames_per_s" else f"{name}.batch"
    want = spec.load_metric(batch).read(run)
    assert want is not None and want > 0
    assert spec.load_metric(f"{name}.flow_batch").read(run) == want


@pytest.mark.parametrize("fault", ["shifted", "none", "unlaunched"])
def test_nothing_is_read_where_the_records_miss_the_trace(program, fault):
    trace = _trace(LAUNCHES)
    if fault == "shifted":  # a clock 1 s off: nothing inside an entry span
        program[:] = [dataclasses.replace(r, start_ns=r.start_ns + 10 ** 9,
                                          end_ns=r.end_ns + 10 ** 9)
                      for r in RECS]
    elif fault == "none":  # a program that keeps no records
        program.clear()
    else:  # one launch in 5 lies outside the entry span
        trace = _trace(LAUNCHES[:4] + [(150, 152, 1)])
    assert stages.of(types.SimpleNamespace(trace=trace)) is None
