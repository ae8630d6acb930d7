"""Readings of the comparison that decides ``correct``, outside the timed
runs: for each seed, the pool a run of the cell makes, the frames of its
first ``check_calls`` calls, and the number compared (compare.checks)

  * of the program: the cell's driver on those calls, as the window runs
    them (the lower reading, beside the timed runs' own);
  * of each control: the plain reference computed in a lowered precision
    (reference/sgm.py CONTROLS), put in the program's place (the upper
    reading: it has to come out as not correct).

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \\
        [--controls cost_int4,subpixel_bf16] [--device cuda]

One JSON line a seed and reading on standard output.  The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def readings(cell_name: str, seed: int, controls, device) -> list[dict]:
    import torch

    from benchmark import compare, harness, spec
    cell = spec.cell(spec.load_benchmark(), cell_name)
    cfg = spec.load_config(cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    driver = spec.load_driver(traffic["driver"])
    frames = traffic["frames_per_call"]
    imgs_a, imgs_b = harness.make_pool(cfg, traffic, seed, device)
    n = traffic["check_calls"] * frames
    a, b = imgs_a[:n], imgs_b[:n]
    reference = spec.load_reference(cfg["kind"])
    call = driver.build(cfg)
    got = [harness.outputs(call(a[k:k + frames], b[k:k + frames])
                            if driver.FRAME_AXIS else call(a[k], b[k]),
                            driver.FRAME_AXIS) for k in range(0, n, frames)]
    got = tuple(torch.cat(parts) for parts in zip(*got))
    t = time.perf_counter()
    want = reference.run(a, b, cfg)
    ref_s = time.perf_counter() - t
    out = []
    for name, outputs in [("program", got)] + [
            (c, reference.run(a, b, cfg, control=c)) for c in controls]:
        checks, failed = compare.checks(outputs, want, cfg["limits"])
        out.append({"workload": cell_name, "seed": seed, "reading": name,
                    "frames": n, "failed_frames": failed,
                    "reference_s": ref_s,
                    **{k: v["value"] for k, v in checks.items()}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="cost_int4,subpixel_bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    device = torch.device(args.device)
    controls = [c for c in args.controls.split(",") if c]
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings(args.workload, seed, controls, device):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main())
