"""The benchmark's files, found by the names BENCHMARK.json gives them.

    BENCHMARK.json                       cells, configurations, metrics
    benchmark/configs/<config>.json      a configuration: kind, sizes and
                                         the program's parameters
    benchmark/traffic/<traffic>.json     a traffic mix: driver, frames a
                                         call, pool, generator, samples
    benchmark/drivers/<driver>.py        build(cfg) -> call(a, b): the call
                                         into the program for one entry;
                                         optional close(call) and
                                         memory_peak_bytes(call) (a peak
                                         a card) for a driver with ranks
                                         on other cards
    benchmark/inputs/<generator>.py      make(frames, cfg, gen, **args)
    benchmark/reference/<kind>.py        run(a, b, cfg, control=None);
                                         SMALL, the tests' sizes
    benchmark/work/<kind>.py             aggregate_work(cfg) -> (bytes, ops)
    benchmark/metrics/<metric>.py        read(run) -> value or None
    benchmark/kernels/*.json             hand-written kernel -> stage
    benchmark/work/peaks.json            the cards' peak rates

A later change adds a cell, a mix, a configuration or a metric by adding
files and entries; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench['workloads']]}")


def load_config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def load_traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def load_file_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py, loaded by its path (a metric's name may
    hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name: str):
    return load_file_module("drivers", name)


def load_generator(name: str):
    return load_file_module("inputs", name)


def load_metric(name: str):
    return load_file_module("metrics", name)


def load_reference(kind: str):
    return importlib.import_module(f"benchmark.reference.{kind}")


def load_work(kind: str):
    return importlib.import_module(f"benchmark.work.{kind}")


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those whose ``workloads`` name it, or that have none."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def kernel_stages() -> dict[str, str]:
    stages: dict[str, str] = {}
    for path in sorted((HERE / "kernels").glob("*.json")):
        stages.update(_json(path)["kernels"])
    return stages


def peaks(card: str) -> dict | None:
    """{"bytes_per_s", "ops_per_s"} of the card, None for an unlisted one."""
    return _json(HERE / "work" / "peaks.json")["cards"].get(card)


def params_kwargs(cfg: dict) -> dict:
    """The configuration's parameters as keyword arguments of the
    program's parameter classes (JSON lists as tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg["params"].items()}
