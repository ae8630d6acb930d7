"""Throughput harness of the port: bench.py's six cells on one card.

    python -m fsgm_tpu_torch.bench [--config kitti] [--batch B] \\
        [--stages] [--guard] [--sustained K] [--trace DIR] \\
        [--fb-backward half|single|full|cheap] [--fb-grid half|full] \\
        [--device cuda]
    python -m fsgm_tpu_torch.cli bench ...      (the same, in one process)

Counterpart of the repository's bench.py.  Each cell (CONFIGS) runs its
preset (configs/*.json, through bench_params) on B synthetic pairs made
from seeds 0 .. B-1: random_dot_stereo(H, W, D, seed=s) through
stereo_sgm_batch, or constant_flow_pair(H, W, 3, -2, seed=s) through
flow_fsgm_batch (all B frames in one pass: one launch set a pyramid level,
the forward and backward passes in lockstep where both run).

stdout is exactly one JSON line, {"metric", "value", "unit",
"vs_baseline"}: Mpixel*disp/s = label-pixels per frame x frames/s / 1e6
(H*W*D for stereo, flow_label_pixels for flow) and its ratio to
BASELINE_MPDS.  Context goes to stderr as lines that start with '#':
"# bench {json}" (ms/frame, fps, first_call_s, vs_SoL, peak_mib, the
card's name), the guard's verdict, then whatever --sustained, --trace and
--stages add.

Timing.  One warm-up call comes first; it includes any first-use nvcc
build of the kernels and is reported as first_call_s (host clock), never
in the median.  Then 6 calls, each between two CUDA events with a
synchronisation after it; ms/frame is their median over B.  An event pair
around a blocking call measures from the first launch to the last
completion, so where the host enqueues more slowly than the card runs
(single stereo frames, flow's many small launches) the host's gaps are in
the number.  On the CPU the host clock takes the events' place.

vs_SoL (stereo cells only): the least time of sgm_bytes_model's bytes
(K1, K2 as launch_plan launches it, K3) at the card's HBM peak
(utils/profiling.py HBM_PEAK_GBS) over the measured time; null where the
card has no listed peak.  Flow has no bytes model yet, so its cells print
no vs_SoL.

--stages (stereo cells): per-stage times by CUDA events over STAGE_ITERS
repetitions of the cell's call, each stage the code the pipeline runs for
it: census_cost (census of both views and K1), agg_down / agg_up /
agg_cols (the P2' tables and K2 launches of the directions with dy > 0,
dy < 0 and dy = 0, launched as aggregate_paths' launch_plan launches
them; a family launch of the dy != 0 group is the one stage agg_down_up)
and extract (K3 and the subpixel / LR / median tail); bytes from
sgm_bytes_model, printed as utils/profiling.py StageTimer JSONL.

--guard exits 3 when ms/frame exceeds best_ms_frame * (1 + tolerance) of
the cell's entry in HISTORY (fsgm_tpu_torch/bench_history.json); the
verdict is printed in every run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from fsgm_tpu_torch.io import constant_flow_pair, random_dot_stereo
from fsgm_tpu_torch.models.flow import flow_fsgm_batch
from fsgm_tpu_torch.models.stereo import disparity_tail, stereo_sgm_batch
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.kernels import aggregate as agg
from fsgm_tpu_torch.ops.kernels import cost, extract
from fsgm_tpu_torch.params import load_preset
from fsgm_tpu_torch.utils.profiling import (StageTimer, hbm_peak_gbs,
                                            sgm_bytes_model, sync, trace)

# The prior-art anchor of BASELINE.md (Mpixel*disp/s): embedded-GPU SGM,
# about 42 fps at 640x480, D = 128, 4 paths on a Tegra X1 (PAPERS.md,
# arxiv 1610.04121).
BASELINE_MPDS = 1650.0
CONFIGS = {
    # name: (H, W, D or labels, batch, metric name, preset file)
    "kitti": (375, 1242, 128, 16, "kitti_stereo_sgm_throughput",
              "kitti_stereo.json"),
    "tsukuba": (288, 384, 64, 16, "tsukuba_stereo_sgm_throughput",
                "tsukuba.json"),
    "kitti16": (375, 1242, 128, 16, "kitti_16path_adaptive_throughput",
                "kitti_16path.json"),
    "4k": (2160, 3840, 128, 2, "uhd_stereo_sgm_throughput",
           "tiled_4k.json"),
    "flow": (368, 1232, 81, 8, "kitti_flow_fsgm_throughput",
             "kitti_flow.json"),
    # the 4K flow leg of config 5: one pyramid level more (bench_params)
    "4kflow": (2160, 3840, 81, 1, "uhd_flow_fsgm_throughput",
               "kitti_flow.json"),
}
FLOW_CELLS = ("flow", "4kflow")
CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"
HISTORY = Path(__file__).resolve().parent / "bench_history.json"
REPEATS = 6
STAGE_ITERS = 10
FLOW_MOTION = (3, -2)  # constant_flow_pair's (u, v)


def bench_params(cfg: str, fb_backward: str | None = None,
                 fb_grid: str | None = None):
    """The parameters cell ``cfg`` runs, built from its preset file; the
    4K flow leg runs one pyramid level more (5: coarsest 135x240), and
    fb_backward / fb_grid replace the flow preset's."""
    preset = load_preset(str(CONFIG_DIR / CONFIGS[cfg][5]))
    if cfg not in FLOW_CELLS:
        return preset["sgm"]
    p = preset["flow"]
    if cfg == "4kflow":
        p = dataclasses.replace(p, levels=5)
    if fb_backward or fb_grid:
        p = dataclasses.replace(p, fb_backward=fb_backward or p.fb_backward,
                                fb_grid=fb_grid or p.fb_grid)
    return p


def flow_label_pixels(h: int, w: int, fp) -> int:
    """Label-pixels a flow frame aggregates: H_l * W_l summed over the
    pyramid levels each direction runs (the backward one at half
    resolution under fb_backward='half', full resolution only under
    'single'), times the label count."""
    dims = [(h, w)]
    for _ in range(fp.levels - 1):
        dims.append((dims[-1][0] // 2, dims[-1][1] // 2))
    fwd = sum(hh * ww for hh, ww in dims)
    if fp.fb_backward == "half":
        bwd = sum(hh * ww for hh, ww in dims[1:])
    elif fp.fb_backward == "single":
        bwd = h * w
    else:                       # 'full' / 'cheap' aggregate every level
        bwd = fwd
    return (fwd + bwd) * fp.num_labels


class _Clock:
    """Marks in a stream of work: CUDA events on a card, the host clock
    (the work is synchronous there) on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(self, a, b) -> float:
        """Seconds from mark a to mark b (after b completed)."""
        if not self.cuda:
            return b - a
        b.synchronize()
        return a.elapsed_time(b) / 1e3


def _inputs(cfg: str, h: int, w: int, d: int, batch: int,
            dev: torch.device):
    if cfg in FLOW_CELLS:
        pairs = [constant_flow_pair(h, w, *FLOW_MOTION, seed=s)
                 for s in range(batch)]
    else:
        pairs = [random_dot_stereo(h, w, d, seed=s)[:2]
                 for s in range(batch)]
    return (torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev),
            torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev))


def _k2_launches(params, shape, dev) -> list:
    """[(directions, family)] of each K2 launch launch_plan makes."""
    out = []
    for group, family in agg.launch_plan(shape, dev, params.dirs, params.p1,
                                         params.p2, params.s_invalid):
        out += [(group, True)] if family else [([r], False) for r in group]
    return out


def _bytes_model(params, shape, dev):
    """(sgm_bytes_model of a (B, H, W, D) call as launch_plan launches K2
    on dev, the K2 launches, S's item size)."""
    bsz, h, w, d = shape
    s_item = torch.tensor(
        [], dtype=agg.plan_dtypes(params.s_invalid)).element_size()
    launches = _k2_launches(params, shape, dev)
    model = sgm_bytes_model(h, w, d, len(params.dirs), s_item, bsz,
                            [len(g) for g, _ in launches])
    return model, launches, s_item


def _stage_of(dirs, family: bool) -> str:
    if dirs[0][0] == 0:
        return "agg_cols"
    if family:
        return "agg_down_up"
    return "agg_down" if dirs[0][0] > 0 else "agg_up"


def stage_roofline(params, a: torch.Tensor, b: torch.Tensor,
                   iters: int = STAGE_ITERS) -> StageTimer:
    """The stereo pipeline over (B, H, W) pairs a, b split into its stages
    (module docstring), each timed over ``iters`` runs of the whole
    pipeline after one warm-up run, with its bytes from sgm_bytes_model."""
    dev = a.device
    bsz, h, w = a.shape
    d = params.max_disp
    model, launches, s_item = _bytes_model(params, (bsz, h, w, d), dev)
    kw = dict(s_dtype=agg.plan_dtypes(params.s_invalid),
              p2_max=agg.p2_bound(params.p1, params.p2))
    clock = _Clock(dev)

    def table(r):
        return agg.p2_effective(a, r, params.p1, params.p2,
                                params.adaptive_p2)

    def run(marks: list) -> None:
        marks.append(("", clock.mark()))
        c = cost.census_cost(census_transform(a, params.census_window),
                             census_transform(b, params.census_window), d,
                             params.invalid_cost, False, params.census_bits)
        marks.append(("census_cost", clock.mark()))
        s = None
        for dirs, family in launches:
            if family:
                s = agg.sgm_sweep_family(
                    c, torch.stack([table(r) for r in dirs]), dirs,
                    params.p1, s=s, **kw)
            else:
                s = agg.sgm_sweep(c, table(dirs[0]), dirs[0], params.p1,
                                  s=s, **kw)
            marks.append((_stage_of(dirs, family), clock.mark()))
        del c
        disparity_tail(extract.extract_stereo(
            s, params.s_invalid, params.lr_max_diff, params.subpixel,
            with_rwta=params.lr_check), params)
        marks.append(("extract", clock.mark()))

    run([])
    sync(dev)
    marks = []
    for _ in range(iters):
        run(marks)
    sync(dev)
    seconds, nbytes = {}, {}
    for (_, t0), (name, t1) in zip(marks, marks[1:]):
        if name:
            seconds[name] = seconds.get(name, 0.0) + clock.seconds(t0, t1)
    for dirs, family in launches:
        name = _stage_of(dirs, family)
        nbytes[name] = nbytes.get(name, 0) + sgm_bytes_model(
            h, w, d, len(dirs), s_item, bsz, [len(dirs)])["aggregate"]
    nbytes.update(census_cost=model["cost"], extract=model["extract"])
    timer = StageTimer(dev)
    for name in ("census_cost", "agg_down", "agg_up", "agg_down_up",
                 "agg_cols", "extract"):
        if name in seconds:
            timer.record(name, seconds[name], nbytes[name] * iters)
    return timer


def regression_guard(cfg: str, ms_frame: float) -> str | None:
    """'OK' or 'REGRESSION' against the cell's entry in HISTORY (printed
    to stderr), None where HISTORY has none."""
    try:
        entry = json.loads(HISTORY.read_text())["configs"][cfg]
    except (OSError, KeyError, ValueError):
        print(f"# guard: no recorded best for cfg={cfg} in {HISTORY}",
              file=sys.stderr)
        return None
    best, tol = entry["best_ms_frame"], entry["tolerance"]
    limit = best * (1 + tol)
    verdict = "OK" if ms_frame <= limit else "REGRESSION"
    print(f"# guard: {verdict} cfg={cfg} {ms_frame:.4f} ms/frame vs best "
          f"{best:.4f} (+{tol:.0%} tolerance = {limit:.4f}) on "
          f"{entry.get('card', 'an unnamed card')}", file=sys.stderr)
    return verdict


def run_config(cfg: str, device="cuda", batch: int | None = None,
               shape: tuple | None = None, stages: bool = False,
               guard: bool = False, sustained: int = 0,
               trace_dir: str | None = None, fb_backward: str | None = None,
               fb_grid: str | None = None) -> dict:
    """Run cell ``cfg`` on ``device``: print the stdout line and the
    stderr context (module docstring) and return the context record, the
    stdout record under "record".  ``shape`` (H, W) replaces the cell's
    frame size (for small runs on the CPU).  With ``guard``, a regression
    raises SystemExit(3) after the verdict is printed."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    h, w, d, batch_default, metric, _ = CONFIGS[cfg]
    if shape is not None:
        h, w = shape
    batch = batch or batch_default
    flow = cfg in FLOW_CELLS
    params = bench_params(cfg, fb_backward, fb_grid)
    if flow:
        label_px = flow_label_pixels(h, w, params)

        def run():
            return flow_fsgm_batch(a, b, params)
    else:
        if params.max_disp != d:
            raise ValueError(f"{cfg}: preset D {params.max_disp} != {d}")
        label_px = h * w * d

        def run():
            return stereo_sgm_batch(a, b, params)
    a, b = _inputs(cfg, h, w, d, batch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run()
    sync(dev)
    first_call_s = time.perf_counter() - t0
    clock = _Clock(dev)
    times = []
    for _ in range(REPEATS):
        t = clock.mark()
        run()
        times.append(clock.seconds(t, clock.mark()))
    dt = float(np.median(times)) / batch
    peak_mib = (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                if dev.type == "cuda" else None)
    mpds = label_px / dt / 1e6
    rec = {"metric": metric, "value": round(mpds, 1),
           "unit": "Mpixel*disp/s",
           "vs_baseline": round(mpds / BASELINE_MPDS, 3)}
    print(json.dumps(rec))
    vs_sol = None
    peak_gbs = hbm_peak_gbs(dev)
    if not flow and peak_gbs is not None:
        total = _bytes_model(params, (batch, h, w, d), dev)[0]["total"]
        vs_sol = total / batch / (peak_gbs * 1e9) / dt
    ctx = {"cfg": cfg, "device": str(dev),
           "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else None),
           "batch": batch, "shape": [h, w, d], "ms_frame": dt * 1e3,
           "fps": 1.0 / dt, "mpds": mpds, "first_call_s": first_call_s,
           "vs_SoL": vs_sol, "peak_mib": peak_mib,
           "ms_calls": [t * 1e3 for t in times]}
    print(f"# bench {json.dumps(ctx)}", file=sys.stderr)
    ctx["record"] = rec
    ctx["guard"] = regression_guard(cfg, dt * 1e3)
    if guard and ctx["guard"] == "REGRESSION":
        raise SystemExit(3)
    if sustained > 0:
        # K calls queued back to back, one synchronisation at the end
        t = clock.mark()
        for _ in range(sustained):
            run()
        sus = clock.seconds(t, clock.mark()) / (sustained * batch)
        ctx["sustained_ms_frame"] = sus * 1e3
        print(f"# sustained: {sustained} queued calls, {sus * 1e3:.4f} "
              f"ms/frame ({label_px / sus / 1e6:.1f} Mpixel*disp/s); "
              f"blocking {dt * 1e3:.4f}", file=sys.stderr)
    if trace_dir:
        with trace(trace_dir):
            run()
            sync(dev)
        print(f"# trace of one call written to {trace_dir}", file=sys.stderr)
    if stages and not flow:
        timer = stage_roofline(params, a, b)
        print(f"# stage roofline ({STAGE_ITERS} runs of {batch} frames, "
              f"modelled bytes, peak {timer.peak_gbs} GB/s):",
              file=sys.stderr)
        timer.print_report(file=sys.stderr)
        ctx["stages"] = timer.report()
    return ctx


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--config", default="kitti", choices=list(CONFIGS))
    ap.add_argument("--batch", type=int,
                    help="frames per call (default: the cell's)")
    ap.add_argument("--trace", metavar="DIR",
                    help="torch.profiler Chrome trace of one call into DIR")
    ap.add_argument("--stages", action="store_true",
                    help="per-stage roofline JSONL on stderr (stereo cells)")
    ap.add_argument("--guard", action="store_true",
                    help="exit 3 on a ms/frame regression against "
                    "fsgm_tpu_torch/bench_history.json")
    ap.add_argument("--sustained", type=int, default=0, metavar="K",
                    help="also time K calls queued back to back")
    ap.add_argument("--fb-backward", dest="fb_backward",
                    choices=["half", "single", "full", "cheap"],
                    help="flow cells: instead of the preset's fb_backward")
    ap.add_argument("--fb-grid", dest="fb_grid", choices=["half", "full"],
                    help="flow cells: instead of the preset's fb_grid")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def run_args(args) -> int:
    run_config(args.config, args.device, batch=args.batch,
               stages=args.stages, guard=args.guard,
               sustained=args.sustained, trace_dir=args.trace,
               fb_backward=args.fb_backward, fb_grid=args.fb_grid)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fsgm_tpu_torch.bench")
    add_arguments(ap)
    return run_args(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
