"""No run loads JAX, the JAX package or its golden model, and the
reference loads nothing of the program (module names compared whole at
their top level: fsgm_tpu_torch begins with fsgm_tpu)."""

import json
import subprocess
import sys

from benchmark import guard, spec


def _loaded(code: str) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "; import sys, json; print(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=spec.ROOT).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["fsgm_tpu_torch", "fsgm_tpu_torch.ops",
                                   "jaxtyping", "goldens", "torch"]) == []
    assert guard.forbidden_loaded(["fsgm_tpu.ops", "jax.numpy", "golden",
                                   "flax.linen"]) == ["flax", "fsgm_tpu",
                                                      "golden", "jax"]


def test_reference_loads_nothing_of_the_program():
    names = _loaded("import benchmark.reference.stereo, "
                    "benchmark.reference.flow, benchmark.compare")
    assert "torch" in names
    assert not {"fsgm_tpu_torch", *guard.FORBIDDEN} & set(names)


def test_a_run_loads_nothing_forbidden():
    """A whole (CPU, test-size) run of each kind of cell, its drivers,
    metrics and the program included."""
    code = (
        "import time, torch; "
        "from benchmark import harness, spec; "
        "from benchmark.tests.conftest import shrink; "
        "lc = spec.load_config; "
        "spec.load_config = lambda n: shrink(lc(n)); "
        "[spec.load_metric(m['name']) for g in ('end_to_end', 'per_layer') "
        "for m in spec.load_benchmark()[g]]; "
        "[harness.run_cell(c, 3, 0.01, False, torch.device('cpu'), "
        "time.perf_counter()) for c in ('stereo_kitti.batch16', "
        "'flow_kitti.stream')]")
    names = _loaded(code)
    assert "fsgm_tpu_torch" in names
    assert guard.forbidden_loaded(names) == []
