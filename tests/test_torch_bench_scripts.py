"""PyTorch port: the benches under fsgm_tpu_torch/utils/ (the kernels',
flow_bench.py and flow_cost_bench.py), run as the README runs them (``python
fsgm_tpu_torch/utils/k13_bench.py``).

A script's directory leads sys.path, and that directory holds the port's
utils/logging.py; each bench takes it out before torch imports the standard
library's logging.  With no card visible a bench must reach its own
"no CUDA device available" exit (code 1), not fail while importing torch.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("bench", ["k2", "k4", "k5", "k13", "flow",
                                   "flow_cost"])
def test_bench_script_reaches_its_no_card_exit(bench):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, f"fsgm_tpu_torch/utils/{bench}_bench.py"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert proc.stderr.strip().splitlines()[-1] == \
        f"{bench}_bench: no CUDA device available", proc.stderr[-2000:]
