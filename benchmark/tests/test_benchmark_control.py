"""The comparison that decides ``correct`` fails what it must: the
controls (the reference in a lowered precision, in the program's place)
and a run whose timed path is broken underneath (each fault a cell can
have), on the CPU at test sizes.  The chip's readings at the cells' own
sizes are benchmark/control.py's (PERF.md)."""

import time
import types

import pytest
import torch

from benchmark import control, harness, spec
from benchmark.reference.sgm import CONTROLS
from benchmark.tests.conftest import cells

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["stereo_kitti.batch16",
                                  "flow_kitti.batch8"])
def test_controls_fail_and_the_program_passes(cell, small_cells):
    got = {r["reading"]: r for r in control.readings(cell, 2 ** 31 + 3,
                                                    CONTROLS, CPU)}
    limit = spec.load_config(spec.cell(spec.load_benchmark(), cell)
                             ["config"])["limits"]["mismatched_px"]
    assert got["program"]["mismatched_px"] <= limit
    for c in CONTROLS:
        assert got[c]["mismatched_px"] > limit, c


def _stale(call):
    last = []

    def broken(a, b):  # every call answers with the one before's output
        out = call(a, b)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return broken


def _half_batch(call):
    def broken(a, b):  # the second half of the frames copies the first
        half = a.shape[0] // 2
        out = call(a[:half], b[:half])
        out = out if isinstance(out, tuple) else (out,)
        return tuple(torch.cat([o, o]) for o in out)
    return broken


def _altered(call):
    def broken(a, b):  # one pixel of the first output changed
        out = call(a, b)
        out = out if isinstance(out, tuple) else (out,)
        first = out[0].clone()
        first.view(-1)[first.numel() // 2] += 1
        return (first,) + out[1:]
    return broken


FAULTS = {"stale": _stale, "half_batch": _half_batch, "altered": _altered}


def _cases():
    for cell in cells():
        traffic = spec.load_traffic(spec.cell(spec.load_benchmark(), cell)
                                    ["traffic"])
        for fault in FAULTS:
            if fault != "half_batch" or traffic["frames_per_call"] > 1:
                yield cell, fault


@pytest.mark.parametrize("cell,fault", list(_cases()))
def test_a_broken_timed_path_is_not_correct(cell, fault, small_cells,
                                            monkeypatch):
    load_driver = spec.load_driver

    def broken_driver(name):
        real = load_driver(name)
        return types.SimpleNamespace(
            FRAME_AXIS=real.FRAME_AXIS,
            build=lambda cfg: FAULTS[fault](real.build(cfg)))
    monkeypatch.setattr(spec, "load_driver", broken_driver)
    result = harness.run_cell(cell, 2 ** 31 + 11, 0.05, False, CPU,
                              time.perf_counter())
    assert result["correct"] is False
    assert result["checks"]["mismatched_px"]["value"] > 0
    assert result["failed"] > 0
