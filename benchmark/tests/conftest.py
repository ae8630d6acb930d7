"""CPU fixtures of the benchmark's tests: one intra-op thread, and the
benchmark's cells shrunk to sizes a test run holds (the sizes alone: every
switch of the configuration stays as the cell states it)."""

import pytest
import torch

from benchmark import spec

torch.set_num_threads(1)

SMALL = {"stereo": dict(height=40, width=56, params=dict(max_disp=32)),
         "flow": dict(height=40, width=56,
                      params=dict(levels=2, search_radius=2))}


def shrink(cfg: dict) -> dict:
    small = SMALL[cfg["kind"]]
    return {**cfg, "height": small["height"], "width": small["width"],
            "params": {**cfg["params"], **small["params"]}}


@pytest.fixture
def small_cells(monkeypatch):
    """spec.load_config / load_traffic at test sizes: 2 frames a batch
    call, 2 sampled calls, 3 calls in the pool."""
    load_config, load_traffic = spec.load_config, spec.load_traffic

    def traffic(name):
        t = dict(load_traffic(name))
        t["frames_per_call"] = min(t["frames_per_call"], 2)
        t["check_calls"] = min(t["check_calls"], 2)
        t["pool_calls"] = 3
        return t
    monkeypatch.setattr(spec, "load_config", lambda n: shrink(load_config(n)))
    monkeypatch.setattr(spec, "load_traffic", traffic)


def cells() -> list[str]:
    return [w["name"] for w in spec.load_benchmark()["workloads"]]
