"""The benchmark of fsgm_tpu_torch on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix and
metrics are read from BENCHMARK.json and the files under benchmark/ by
their names (benchmark/spec.py); harness.py says what a run does.

A cell that asks for several cards (``chips``) runs from this one
process on card 0 (rank 0); the cell's driver starts and owns the ranks on
the other cards, and ends them in its ``close`` or when this process
exits (harness.py).  The traced per-layer metrics and the breakdown of
such a cell see rank 0's process and card alone.

Standard output's last line is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones), ``device``, with --trace 1
``breakdown``, and last ``checks``, each number compared with its limit.
Standard error names the card and its power limit, the window's sample
count and, as its last lines, the checks again.

Exit status: 0 with a result line; 2 without enough CUDA cards; 3 when a
module of the JAX package (or JAX) is loaded; 4 when no profile recorded
device activity; anything else is a fault of the run.  None of these
prints a result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def prepare_process() -> None:
    """Run as a script: the checkout's root on the path in place of
    benchmark/ (whose file names must not shadow the standard library's),
    and the caches a run fills inside the checkout at a fixed path, so
    that a checkout's later runs find what its first run made: the CUDA
    driver's cache of compiled kernels, and Python's bytecode (where the
    environment forbids writing it beside the sources, every run would
    compile torch's anew: 8 s of set-up on the chip machine).  The program
    builds its own kernels with nvcc under build/fsgm_tpu_torch/; it uses
    neither Triton, torch.compile nor torch's extension builder."""
    sys.path[0] = str(ROOT)
    cache = ROOT / "build" / "benchmark_cache"
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return proc.stdout.strip() or proc.stderr.strip()


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import devtrace, harness, spec
    harness.log(f"set-up: torch imported at {time.perf_counter() - T0:.3f} s")
    torch.set_num_threads(1)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"card(s), found {have}; no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    harness.log(f"set-up: CUDA initialised at "
                f"{time.perf_counter() - T0:.3f} s")
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device, T0)
    except harness.ForbiddenModule as e:
        print(f"benchmark: forbidden module {e}; no result", file=sys.stderr)
        return 3
    except devtrace.NoDeviceActivity as e:
        print(f"benchmark: {e}; no result", file=sys.stderr)
        return 4
    harness.log(f"card: {power_limit()}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    prepare_process()
    sys.exit(main())
