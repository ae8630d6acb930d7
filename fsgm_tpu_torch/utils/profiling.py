"""Where the time of one frame goes, from torch.profiler.

    python -m fsgm_tpu_torch.utils.profiling [--pipeline stereo|flow|tiled] \\
        [--preset configs/kitti_stereo.json] [--height 375] [--width 1242] \\
        [--batch 1] [--tile-mode fast|exact] [--calls 10] [--warmup 3] \\
        [--seed 0] [--device cuda]

``--pipeline stereo`` (the default) runs stereo_sgm_batch on B random-dot
pairs (seeds seed .. seed + B - 1; B = 1 is stereo_sgm) of the given size at
the preset's D (default preset configs/kitti_stereo.json) in one call, and
every number below is per frame, i.e. per call divided by B.
``--pipeline flow`` runs flow_fsgm_batch on B blockwise_flow_pairs of that
size with motion up to 8 px (seeds seed .. seed + B - 1; B = 1 is
flow_fsgm; default preset configs/kitti_flow.json) in one call, numbers
per frame.  ``--pipeline tiled`` runs stereo_sgm_sharded on
B random-dot pairs with the preset's distribution (default
configs/tiled_4k.json, config 5; ``--tile-mode`` overrides its mode), every
tile on the card, numbers per frame.  Each runs ``warmup`` calls first,
then prints one line per kernel name (launches per frame, ms per frame,
share of the busy time), then the totals, and last the whole record as one
JSON object:

  * ``busy_ms``: the sum of the rows, per frame, from torch.profiler over
    ``calls`` back-to-back calls.  On a card the rows are the device's
    kernels (and memsets/copies); on the CPU they are the ops' self time;
  * ``wall_ms``: one frame of ``calls`` back-to-back calls with the
    profiler off, by CUDA events on a card and the host clock on the CPU;
  * ``launches``: device kernels, memsets and copies per frame;
  * ``busy_share`` = busy_ms / wall_ms; on a card, 1 - busy_share is the
    device's idle share;
  * ``peak_mib``: the card's peak allocation over one call, i.e. all B
    frames of a batch (None on the CPU).

The module also holds the port's counterparts of fsgm_tpu/utils/
profiling.py's tools, which the bench (fsgm_tpu_torch/bench.py) uses:

  * ``trace(log_dir)``: a torch.profiler context that writes a Chrome
    trace (chrome://tracing, Perfetto) of what ran inside it;
  * ``StageTimer``: wall time and modelled bytes per stage, and the
    achieved GB/s against the card's HBM peak (``HBM_PEAK_GBS``);
  * ``sgm_bytes_model``: the bytes the port's stereo kernels K1, K2 and
    K3 must move (PERF.md's kernel table).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fsgm_tpu_torch.io import blockwise_flow_pair, random_dot_stereo
from fsgm_tpu_torch.models.flow import flow_fsgm, flow_fsgm_batch
from fsgm_tpu_torch.models.stereo import stereo_sgm_batch
from fsgm_tpu_torch.params import (DistParams, FlowParams, SGMParams,
                                   load_preset)
from fsgm_tpu_torch.parallel import stereo_sgm_sharded

CONFIGS = Path(__file__).resolve().parents[2] / "configs"
PRESETS = {"stereo": CONFIGS / "kitti_stereo.json",
           "flow": CONFIGS / "kitti_flow.json",
           "tiled": CONFIGS / "tiled_4k.json"}
FLOW_MAX_MAG = 8  # px of motion in the flow pipeline's synthetic pair
# HBM peak (GB/s) by torch.cuda.get_device_name(): the H100 SXM's public
# data-sheet rate.  A card not listed (and the CPU) has no peak.
HBM_PEAK_GBS = {"NVIDIA H100 80GB HBM3": 3350.0}
TRACE_FILE = "trace.json"


def hbm_peak_gbs(dev: torch.device) -> float | None:
    """The HBM peak of dev's card from HBM_PEAK_GBS; None on the CPU or
    for a card the table does not list."""
    if dev.type != "cuda":
        return None
    return HBM_PEAK_GBS.get(torch.cuda.get_device_name(dev))


@contextlib.contextmanager
def trace(log_dir):
    """torch.profiler over the block (the card's kernels too, where there
    is a card); writes log_dir/trace.json, a Chrome trace."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / TRACE_FILE))


class StageTimer:
    """Wall time and modelled bytes per named stage; report() gives each
    stage's achieved GB/s and its share of the card's HBM peak (None where
    the peak is unknown)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.peak_gbs = hbm_peak_gbs(dev)
        self.stages: dict[str, dict] = {}

    @contextlib.contextmanager
    def stage(self, name: str, bytes_moved: int = 0):
        """Time the block by the host clock between two synchronisations
        of the device."""
        sync(self.dev)
        t0 = time.perf_counter()
        yield
        sync(self.dev)
        self.record(name, time.perf_counter() - t0, bytes_moved)

    def record(self, name: str, seconds: float, bytes_moved: int = 0):
        """A time measured elsewhere (e.g. CUDA events over many calls)."""
        rec = self.stages.setdefault(name, {"s": 0.0, "bytes": 0, "n": 0})
        rec["s"] += seconds
        rec["bytes"] += bytes_moved
        rec["n"] += 1

    def report(self) -> list[dict]:
        out = []
        for name, r in self.stages.items():
            gbs = r["bytes"] / r["s"] / 1e9 if r["s"] > 0 else 0.0
            pct = (None if self.peak_gbs is None
                   else round(100 * gbs / self.peak_gbs, 1))
            out.append({"stage": name, "wall_s": round(r["s"], 6),
                        "calls": r["n"], "bytes": r["bytes"],
                        "achieved_GBps": round(gbs, 1),
                        "pct_of_HBM_peak": pct})
        return out

    def print_report(self, file=None):
        for rec in self.report():
            print(json.dumps(rec), file=file)


def sgm_bytes_model(h: int, w: int, d: int, num_paths: int,
                    s_itemsize: int = 2, batch: int = 1,
                    launches=None) -> dict:
    """Bytes the port's stereo kernels must move for ``batch`` frames of
    H x W x D (PERF.md's kernel table, each input read once and each
    output written once a launch):

      * cost (K1): B * (2*HW*8 + HW*D), two int64 census planes in, the
        uint8 cost volume out;
      * aggregate (K2), summed over its launches: B * (HWD + n*HW*4 +
        s_itemsize*HWD) for a launch of n directions, the cost volume and
        n int32 P2' tables in, S out (2*HWD in int16).  ``launches`` lists
        the directions of each launch (launch_plan's groups); default one
        launch per direction, num_paths of them;
      * extract (K3): B * (s_itemsize*HWD + 5*HW*4), S in, five int32
        planes out.

    An accumulating K2 launch also reads S; like the kernel table, the
    model does not count that read, so it is a floor."""
    hw, vol = h * w, h * w * d
    if launches is None:
        launches = [1] * num_paths
    if sum(launches) != num_paths:
        raise ValueError(f"launches {launches} do not cover {num_paths} "
                         f"directions")
    cost = batch * (2 * hw * 8 + vol)
    aggregate = sum(batch * (vol + n * hw * 4 + s_itemsize * vol)
                    for n in launches)
    extract = batch * (s_itemsize * vol + 5 * hw * 4)
    return {"cost": cost, "aggregate": aggregate, "extract": extract,
            "total": cost + aggregate + extract}


def sync(dev: torch.device) -> None:
    """Wait for dev's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_ms(fn, dev: torch.device, calls: int) -> float:
    """Wall time of one of ``calls`` back-to-back fn() calls."""
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e3 / calls


def profile_frames(frame, dev: torch.device, calls: int = 10,
                   warmup: int = 3, frames_per_call: int = 1) -> dict:
    """The per-frame breakdown record of ``frame()``, which computes
    ``frames_per_call`` frames, on device ``dev`` (see the module
    docstring)."""
    cuda = dev.type == "cuda"
    for _ in range(warmup):
        frame()
    sync(dev)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(calls):
            frame()
        sync(dev)
    kind = DeviceType.CUDA if cuda else DeviceType.CPU
    frames = calls * frames_per_call
    rows = []
    for e in prof.key_averages():
        us = e.self_device_time_total if cuda else e.self_cpu_time_total
        if e.device_type == kind and us > 0:
            rows.append({"name": e.key, "launches": e.count / frames,
                         "ms": us / 1e3 / frames})
    if not rows:
        raise RuntimeError(f"torch.profiler recorded no {kind} time")
    rows.sort(key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    for r in rows:
        r["share"] = r["ms"] / busy
    wall = wall_ms(frame, dev, calls) / frames_per_call
    peak = None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        frame()
        sync(dev)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    return {"device": str(dev), "calls": calls,
            "frames_per_call": frames_per_call, "rows": rows,
            "busy_ms": busy, "wall_ms": wall, "busy_share": busy / wall,
            "launches": sum(r["launches"] for r in rows), "peak_mib": peak}


def profile_stereo(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                   params: SGMParams, calls: int = 10,
                   warmup: int = 3) -> dict:
    """The per-frame breakdown record of stereo_sgm_batch(imgs_l, imgs_r,
    params) over (B, H, W) pairs, or of one (H, W) pair as a batch of 1;
    the device is the images'."""
    if imgs_l.dim() == 2:
        imgs_l, imgs_r = imgs_l[None], imgs_r[None]
    rec = profile_frames(lambda: stereo_sgm_batch(imgs_l, imgs_r, params),
                         imgs_l.device, calls, warmup, imgs_l.shape[0])
    return {"pipeline": "stereo", "batch": imgs_l.shape[0],
            "shape": [*imgs_l.shape[1:], params.max_disp], **rec}


def profile_tiled(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                  params: SGMParams, dist: DistParams, calls: int = 10,
                  warmup: int = 3) -> dict:
    """The per-frame breakdown record of stereo_sgm_sharded(imgs_l, imgs_r,
    params, dist) over (F, H, W) pairs, every tile on the images'
    device."""
    rec = profile_frames(
        lambda: stereo_sgm_sharded(imgs_l, imgs_r, params, dist),
        imgs_l.device, calls, warmup, imgs_l.shape[0])
    return {"pipeline": "tiled", "batch": imgs_l.shape[0],
            "dist": dataclasses.asdict(dist),
            "shape": [*imgs_l.shape[1:], params.max_disp], **rec}


def profile_flow(img1: torch.Tensor, img2: torch.Tensor, params: FlowParams,
                 calls: int = 10, warmup: int = 3) -> dict:
    """The per-frame breakdown record of flow_fsgm_batch(img1, img2,
    params) over (B, H, W) pairs in one pass, or of flow_fsgm on one (H, W)
    pair as a batch of 1; the device is the images'."""
    if img1.dim() == 2:
        b, frame = 1, lambda: flow_fsgm(img1, img2, params)
    else:
        b, frame = img1.shape[0], lambda: flow_fsgm_batch(img1, img2, params)
    rec = profile_frames(frame, img1.device, calls, warmup, b)
    return {"pipeline": "flow", "batch": b,
            "shape": [*img1.shape[-2:], params.num_labels], **rec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fsgm_tpu_torch.utils.profiling")
    ap.add_argument("--pipeline", default="stereo", choices=sorted(PRESETS))
    ap.add_argument("--preset", help="default: configs/kitti_stereo.json, "
                    "kitti_flow.json or tiled_4k.json by pipeline")
    ap.add_argument("--height", type=int, default=375)
    ap.add_argument("--width", type=int, default=1242)
    ap.add_argument("--batch", type=int, default=1, help="B frames per "
                    "call (numbers per frame)")
    ap.add_argument("--tile-mode", choices=["fast", "exact"],
                    help="tiled: instead of the preset's tile_mode")
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    dev = torch.device(args.device)
    preset = load_preset(args.preset or str(PRESETS[args.pipeline]))
    if args.batch < 1:
        raise SystemExit("--batch B takes B >= 1")
    if args.pipeline in ("stereo", "tiled"):
        params = preset["sgm"]
        pairs = [random_dot_stereo(args.height, args.width, params.max_disp,
                                   seed=args.seed + k)
                 for k in range(args.batch)]
        a = np.stack([p[0] for p in pairs])
        b = np.stack([p[1] for p in pairs])
        run = profile_stereo
        if args.pipeline == "tiled":
            dist = preset["dist"]
            if args.tile_mode:
                dist = dataclasses.replace(dist, tile_mode=args.tile_mode)

            def run(il, ir, params, calls, warmup):
                return profile_tiled(il, ir, params, dist, calls, warmup)
    else:
        params = preset["flow"]
        pairs = [blockwise_flow_pair(args.height, args.width, FLOW_MAX_MAG,
                                     seed=args.seed + k)
                 for k in range(args.batch)]
        a = np.stack([p[0] for p in pairs])
        b = np.stack([p[1] for p in pairs])
        if args.batch == 1:
            a, b = a[0], b[0]
        run = profile_flow
    rec = run(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
              params, args.calls, args.warmup)
    if args.device == "cuda":
        rec["card"] = torch.cuda.get_device_name(dev)
    for r in rec["rows"]:
        print(f"{r['share']:7.2%} {r['ms']:9.4f} ms/frame "
              f"{r['launches']:6.1f} launches/frame  {r['name'][:110]}")
    print(f"busy {rec['busy_ms']:.4f} ms/frame, wall {rec['wall_ms']:.4f} "
          f"ms/frame, busy share {rec['busy_share']:.4f}, "
          f"{rec['launches']:.2f} launches/frame, peak {rec['peak_mib']} MiB "
          f"({rec['device']}, {rec['pipeline']}, {rec['frames_per_call']} "
          f"frame(s) per call, shape {rec['shape']})")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
