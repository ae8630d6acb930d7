"""PyTorch port: the stage spans and the launch counter (utils/tracing.py).

  * the span tree of stereo_sgm_batch and of flow_fsgm (config 4's
    switches at 48x64), with ``frames`` on the entry spans and every span
    inside its parent;
  * off (no profiler, outside recording()) nothing is recorded and no
    record_function is entered; recording() without the profiler records
    without one;
  * under a CPU torch.profiler each span is a record_function event, and
    trace_us puts the record within 1 ms of it on the trace's clock, whose
    base is the rule trace_base_ns gives;
  * launched() adds to _build.LAUNCHES and to the innermost open span;
  * past CAP the oldest records go and dropped() counts them;
  * stage_table: self host time and device work by innermost span.
"""

import collections
import dataclasses
import json

import pytest
import torch

from fsgm_tpu_torch.io import blockwise_flow_pair, random_dot_stereo
from fsgm_tpu_torch.models.flow import flow_fsgm
from fsgm_tpu_torch.models.stereo import stereo_sgm_batch
from fsgm_tpu_torch.ops.kernels import _build
from fsgm_tpu_torch.params import FlowParams, SGMParams
from fsgm_tpu_torch.utils import tracing

torch.set_num_threads(1)

# config 4's switches (configs/kitti_flow.json) at a fixture's size
FLOW = FlowParams(search_radius=4, levels=4, fb_backward="half",
                  fb_grid="half")
STEREO = SGMParams(max_disp=16)
LEVEL_STAGES = {"fsgm.cost", "fsgm.transpose", "fsgm.aggregate",
                "fsgm.extract", "fsgm.tail"}


def _stereo():
    pairs = [random_dot_stereo(32, 48, 16, seed=s)[:2] for s in (1, 2)]
    return stereo_sgm_batch(*(torch.stack([torch.from_numpy(p[k])
                                           for p in pairs]) for k in (0, 1)),
                            STEREO)


def _flow():
    a, b, *_ = blockwise_flow_pair(48, 64, 3, seed=5)
    return flow_fsgm(torch.from_numpy(a), torch.from_numpy(b), FLOW)


def _children(recs):
    kids = collections.defaultdict(list)
    for r in sorted(recs, key=lambda r: r.start_ns):
        kids[r.parent].append(r)
    return kids


@pytest.mark.parametrize("entry", ["stereo", "flow"])
def test_span_tree_of_the_entry_points(entry):
    tracing.take()
    with tracing.recording():
        (_stereo if entry == "stereo" else _flow)()
    recs = tracing.take()
    by_id = {r.id: r for r in recs}
    kids = _children(recs)
    (root,) = kids[None]
    assert root.name == f"fsgm.{entry}"
    assert root.attrs == {"frames": 2 if entry == "stereo" else 1}
    assert {r.name for r in recs} <= set(tracing.SPANS)
    for r in recs:  # every span lies inside its parent
        if r.parent is not None:
            up = by_id[r.parent]
            assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
    top = [r.name for r in kids[root.id]]
    if entry == "stereo":
        assert top == ["fsgm.census", "fsgm.census", "fsgm.cost",
                       "fsgm.aggregate", "fsgm.extract", "fsgm.tail"]
        levels = [root]
    else:
        assert top == ["fsgm.pyramid"] * 2 + ["fsgm.census"] * 8 + [
            "fsgm.level"] * 4 + ["fsgm.fb_check"]
        levels = kids[root.id][10:14]
        assert [(lv.attrs["level"], lv.attrs["slices"]) for lv in levels] \
            == [(3, 2), (2, 2), (1, 2), (0, 1)]
        assert LEVEL_STAGES <= {c.name for c in kids[levels[-1].id]}
    for lv in levels:
        (agg,) = [c for c in kids[lv.id] if c.name == "fsgm.aggregate"]
        groups = kids[agg.id]
        assert [len(g.attrs["dirs"]) for g in groups] == [6, 2]
        assert all(g.attrs["family"] is False for g in groups)
        (tail,) = [c for c in kids[lv.id] if c.name == "fsgm.tail"]
        assert [c.name for c in kids[tail.id]] == ["fsgm.median"] * (
            1 if entry == "stereo" else 2)
    assert all(r.launches == 0 for r in recs)  # CPU: no kernel launches


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []

    class Probe:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(tracing._profiler, "record_function", Probe)
    tracing.take()
    _stereo()
    assert tracing.records() == [] and entered == []
    assert tracing.span("fsgm.census") is tracing.span("fsgm.cost")
    with tracing.recording():
        _stereo()
    assert len(tracing.take()) == 10 and entered == []


def test_profiler_events_are_the_records_on_the_traces_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _stereo()
    recs = tracing.take()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = data["baseTimeNanoseconds"]
    assert tracing.trace_base_ns(recs[0].start_ns) == base
    events = sorted((e for e in data["traceEvents"]
                     if e.get("cat") == "user_annotation"
                     and e["name"] in tracing.SPANS), key=lambda e: e["ts"])
    recs.sort(key=lambda r: r.start_ns)
    assert [e["name"] for e in events] == [r.name for r in recs]
    for e, r in zip(events, recs):
        assert abs(tracing.trace_us(r.start_ns) - e["ts"]) < 1e3
        assert abs(tracing.trace_us(r.end_ns) - e["ts"] - e["dur"]) < 1e3


def test_launched_counts_in_launches_and_the_innermost_span(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    tracing.launched("sgm_sweep")
    tracing.take()
    with tracing.recording():
        with tracing.span("fsgm.aggregate"):
            tracing.launched("sgm_sweep")
            with tracing.span("fsgm.aggregate.group"):
                tracing.launched("sgm_sweep")
                tracing.launched("sgm_sweep_family")
    outer, inner = sorted(tracing.take(), key=lambda r: r.start_ns)
    assert _build.LAUNCHES == {"sgm_sweep": 3, "sgm_sweep_family": 1}
    assert (outer.launches, inner.launches) == (1, 2)
    assert inner.parent == outer.id and outer.parent is None


def test_the_cap_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 4)
    monkeypatch.setattr(tracing, "_records", collections.deque(maxlen=4))
    before = tracing.dropped()
    with tracing.recording():
        for k in range(6):
            with tracing.span("fsgm.census", k=k):
                pass
    assert [r.attrs["k"] for r in tracing.take()] == [2, 3, 4, 5]
    assert tracing.dropped() - before == 2
    assert tracing.records() == []


def test_stage_table_self_time_and_device_work():
    ms = 1_000_000
    base = tracing.trace_base_ns(1_790_000_000 * 10 ** 9)
    rec = tracing.Record
    recs = [rec(0, "fsgm.flow", None, base + 0, base + 10 * ms,
                {"frames": 2}, 0),
            rec(1, "fsgm.census", 0, base + 1 * ms, base + 3 * ms, {}, 0),
            rec(2, "fsgm.aggregate", 0, base + 4 * ms, base + 8 * ms, {}, 1),
            rec(3, "fsgm.aggregate.group", 2, base + 5 * ms, base + 7 * ms,
                {}, 2)]
    # (launch us, device us): census, the group, the entry, none
    device = [(1500.0, 100.0), (2500.0, 100.0), (6000.0, 400.0),
              (9000.0, 50.0), (11000.0, 30.0)]
    rows = {r["stage"]: r for r in tracing.stage_table(recs, 2, device,
                                                       base)}
    assert list(rows) == ["fsgm.flow", "fsgm.census", "fsgm.aggregate",
                          "fsgm.aggregate.group", tracing.OUTSIDE]
    assert rows["fsgm.flow"]["host_ms"] == pytest.approx((10 - 2 - 4) / 2)
    assert rows["fsgm.aggregate"]["host_ms"] == pytest.approx(1.0)
    assert rows["fsgm.aggregate.group"]["launches"] == 1.0
    assert rows["fsgm.census"]["device_ms"] == pytest.approx(0.1)
    assert rows["fsgm.aggregate.group"]["device_ms"] == pytest.approx(0.2)
    assert rows["fsgm.aggregate"]["device_ms"] == 0
    assert rows["fsgm.flow"]["device_ms"] == pytest.approx(0.025)
    assert rows[tracing.OUTSIDE]["device_ms"] == pytest.approx(0.015)
    assert dataclasses.asdict(recs[0])["attrs"] == {"frames": 2}
    assert len(tracing.format_table(list(rows.values()))) == 6
