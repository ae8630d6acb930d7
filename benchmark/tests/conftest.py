"""CPU fixtures of the benchmark's tests: one intra-op thread, and the
benchmark's cells shrunk to sizes a test run holds, the ``SMALL`` that the
reference of the configuration's kind states (the sizes alone: every
switch of the configuration stays as the cell states it)."""

import pytest
import torch

from benchmark import spec

torch.set_num_threads(1)


def shrink(cfg: dict, load_reference=None) -> dict:
    """cfg at the SMALL of its kind's reference, found by
    ``load_reference`` (spec.load_reference where None)."""
    small = (load_reference or spec.load_reference)(cfg["kind"]).SMALL
    return {**cfg, "height": small["height"], "width": small["width"],
            "params": {**cfg["params"], **small["params"]}}


@pytest.fixture
def small_cells(monkeypatch):
    """spec.load_config / load_traffic at test sizes: 2 frames a batch
    call, 2 sampled calls, 3 calls in the pool.  The sizes come from the
    references as loaded here, before a test stands in for one."""
    load_config, load_traffic = spec.load_config, spec.load_traffic
    load_reference = spec.load_reference

    def traffic(name):
        t = dict(load_traffic(name))
        t["frames_per_call"] = min(t["frames_per_call"], 2)
        t["check_calls"] = min(t["check_calls"], 2)
        t["pool_calls"] = 3
        return t
    monkeypatch.setattr(spec, "load_config",
                        lambda n: shrink(load_config(n), load_reference))
    monkeypatch.setattr(spec, "load_traffic", traffic)


def cells() -> list[str]:
    return [w["name"] for w in spec.load_benchmark()["workloads"]]
