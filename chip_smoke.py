"""On-card smoke run of the PyTorch port (fsgm_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Nine main paths, three entry points and two paths across ranks: stereo
(configs/kitti_stereo.json, 375x1242, D=128), fSGM flow
(configs/kitti_flow.json, 375x1242, 4 levels, 81 labels; flow_fsgm, each
level's forward and backward passes as one launch set), batched flow
(flow_fsgm_batch, 8 config-4 frames in one pass: "flow_batch", phase 12),
batched stereo
(stereo_sgm_batch, 16 frames of config 2 in one pass), tiled stereo
(stereo_sgm_sharded at config 5, configs/tiled_4k.json: 2 frames of
2160x3840, D=128, 2 frame shards x 4 row tiles, fast mode), tiled flow
(flow_fsgm_sharded, config 4 at 4K with 5 levels, 3 row tiles) and the
tiled flow's frame pass (the same over 2 frames in one pass:
"flow_tiled_batch", phase 13); the bench
(fsgm_tpu_torch/bench.py: bench.py's six cells), `cli video` and `cli
kitti` (phase 10); config 5 with its 2 frame shards on 2 torch.distributed
ranks ("multiproc") and config 4 flow frames on 2 ranks ("multiproc_flow";
phase 11). K2 runs as aggregate_paths plans it on the card
(launch_plan, a choice a direction group): for one KITTI frame the vertical
directions one launch each (sgm_sweep) and the horizontal pair in one
family launch (sgm_sweep_family), on flow as the plan gives it for each
level-pass's slices, 16 frames and the tiled paths one launch per
direction.
Phases, each of which raises on failure (non-zero exit, no ok line):

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the kernels from fsgm_tpu_torch/csrc, one nvcc per source (six
     sources, nine entry points), all started together, and print the
     -Xptxas -v record of every K2 instantiation (registers, shared
     memory, spills) and of K1's, K3's, K4's and min16_probe's (the worst,
     and the main path's);
  2. stereo kernels K1 census_cost (left and right reference, with the
     main path's 32-bit census words and with 64-bit ones), K2 sgm_sweep
     (1D labels; each direction with packed and with int32 labels) and K3
     extract_stereo against their plain PyTorch versions on the card,
     exact, at the KITTI shape (random-dot pair) and at 37x53, D=32;
  3. flow kernels K5 label_minor_from_major, K2 sgm_sweep (2D labels) and
     K4 extract_flow against their plain versions, exact, on one flow level
     with a non-zero prior: the config-4 level-0 shape (375x1242, 81 labels
     padded to 96, blockwise_flow_pair(375, 1242, 8, seed=0)), and 37x53
     with radius 2 and adaptive P2, and with an int32 S; K5 also on random
     bytes at each of config 4's four level shapes (375x1242 ... 46x155,
     96 slots);
  4. stereo_sgm end to end against stereo_sgm_reference (plain versions
     only): identical invalid mask, valid disparities within 1e-3, D1-all
     against the ground truth, and each kernel's launch count in that call;
  5. flow_fsgm end to end against flow_fsgm_reference at config 4:
     identical validity planes, valid flow within 1e-3, Fl-all / EPE /
     valid share against the ground truth, and each kernel's launch count
     in that call held to the lockstep plan (flow_launches: one K5, one K2
     plan and one K4 a level-pass, over 2 slices where the backward pass
     runs); flow_fsgm_batch on 2 frames equals per-frame flow_fsgm;
  6. batched stereo: K1 (left and right reference), K2 (each direction and
     the summed S) and K3 (with and without the right-view pass) over B
     frames against their plain versions, exact, at config 1
     (configs/tsukuba.json, 288x384, D=64) and at config 2, B=16 each (the
     batched path's own shapes), on frames of different content where one
     frame's last row is bright and the next one's first row dark;
     stereo_sgm_batch at config 2
     (the main path, launches counted: one K1, one K2 per direction, one
     K3) and at config 1, B=16 each, and at 4K (configs/tiled_4k.json,
     2160x3840, D=128) with B=2, where the batch's int16 S passes 4 GiB,
     equal to per-frame stereo_sgm bit for bit; stereo_sgm with lr_mode="reagg" and with fill_invalid at config 2
     against stereo_sgm_reference; the `batch` CLI (a --fault-inject run,
     exit 17, then the resume) and a `serve` stereo_batch request on the
     card, on PNGs written to a temporary directory;
  7. CUDA-event timings (median after warm-up) of each kernel and its plain
     version on the main paths' inputs (K2: the frame's 8 launches over
     prebuilt P2' tables; the flow kernels at level 0, K4 and K5 also by
     their torch.profiler device time beside the call's event time; K1, K2
     and K3 also over the 16 frames of the batched path), K5 beside PyTorch's
     own axis exchange (library_ms, and its device time), the device
     launches of the plain-torch flow cost build and census, the pipelines
     end to end, and the batched path's ms and launches per frame at B=1
     and B=16;
  8. tiled: (a) K2 with carry in and out against its plain version, exact:
     on one config-5 tile (rows 540..1079 of 2 frames, 3840x128) in the six
     vertical directions, each from the carry K2 exported over the tile
     above (down) or below (up); at 37x53, D=32, 16 paths, adaptive P2,
     on a 13-row and a 1-row tile; with the 2D label rule at 37x53 radius
     2; (b) K3 with window columns (gx0 < 0, gx0 + W > w_global) against
     its plain version, on KITTI's two column windows and on a random
     int32 volume; (c) config 5 as the preset gives it (fast, auto margin)
     equal to its plain twin stereo_sgm_sharded_reference (the plain K1,
     K2 and K3 on the same tiles) bit for bit, its differing pixel share
     against stereo_sgm_batch printed, and in exact mode equal to
     stereo_sgm_batch on the 2 frames bit for bit (the tiled stereo path:
     launches counted, and the counters); (d)
     KITTI at 3 row tiles: x 2 column tiles exact and lr_mode="reagg"
     equal to stereo_sgm, fast with margin 8 equal to the plain twin
     stereo_sgm_sharded_reference; (e) the 4K flow leg (config 4 with 5
     levels, fb_grid="full") at 3 row tiles, exact, equal to flow_fsgm
     (the tiled flow path: launches counted), and K5, K2 (2D rule, with the
     carries from the tiles above and below) and K4 against their plain
     versions, exact, on its level-0 tile 1 (rows 720..1439 of 2160x3840,
     81 labels in 96 slots); (f) CUDA-event ms per frame
     and peak memory of tiled config 5 (fast, exact) against
     stereo_sgm_batch and of tiled 4K flow against flow_fsgm, and the times
     of K2 with carry on the config-5 tile (and of its two horizontal
     directions on one frame of it, held to their plain versions) and of
     K3 on a KITTI window;
  9. (a) K2's family launch (sgm_sweep_family) against its plain
     version, exact: both direction groups at KITTI for 1 and 16 frames
     (int16 S), at 37x53, 16 paths, adaptive, int32 S, on the config-4
     level-0 flow shape (81 labels in 96), and the down family added into
     an existing S (tools/trexp.py's kernel); K3's right-view pass
     (wta_right) and K3 without it at KITTI and frame by frame over the
     S of 16 KITTI frames, wta_right at tools/strideroll_probe.py's shape
     (376x1280x128 int32); K1 with 9x7 census; the min16_probe forms
     against torch.minimum on 2^26 values and at every head and tail (n = 0
     ... 2^20 + 3, views 0-7 elements off a 16-byte boundary, b at and off
     a's offset) and on a side stream, whose handle _build.stream_of must
     give; (b) aggregate_paths' K2 plan against every
     direction group forced to family launches and to per-direction
     launches, bit for bit, the three calls' launches counted and held to
     the plan and timed per frame: stereo_sgm_batch at config 2 with 1
     frame and 16, at config 1 with 16, and flow_fsgm at config 4; (c)
     CUDA-event ms of each new kernel beside its plain version and bound
     (min16_probe's forms and torch.minimum also by device time),
     the family launches beside the per-direction launches they replace
     (each count read from one call), each KITTI direction alone (ns a
     step), and the plan against both forms over 1 to 8 KITTI frames
     (D=128) and 1 to 16 config-1 frames (D=64) around the rule's
     thresholds;
 10. the bench, video and kitti entry points, each run through the CLI's
     main() in this process with the launch counts cleared just before
     and read just after: `bench --config C` for each of bench.py's six
     cells at its full shape and batch (exactly one stdout line with the
     cell's metric and a positive value; each cell's K1, K2 and K3
     launches held to the warm-up and timed calls' plan, K2 also on
     flow), its ms/frame, first_call_s, peak MiB, vs_SoL and guard verdict
     printed (the guard is not enforced: its verdict depends on the
     card); `python -m fsgm_tpu_torch.cli bench --config kitti` once with
     --stages (every stage span reported, with device ms on the kernel
     stages and launches on K1-K3's) and once with --trace (the trace
     file exists) in their own processes; `video` over 4 frames of
     constant_flow_sequence(375, 1242, 3, -2) at config 4 with
     --track-levels 2 into .flo files, equal within 1e-3 (identical
     valid masks) to flow_sequence in this process and to the plain
     chain (flow_fsgm_reference with each pair's prior); `kitti stereo`
     (config 2) and `kitti flow` (config 4) over a 2-frame 375x1242
     KITTI 2015 tree written here, each record equal to stereo_sgm /
     flow_fsgm scored in this process;
 11. across ranks (fsgm_tpu_torch/parallel/multihost.py, ranks.py): 2
     torch.distributed ranks (gloo, the frames gathered through the host)
     as processes sharing this card, in one launch: (a) config 5 as the
     preset gives it (fast, auto margin, 2 frame shards = 2 ranks x 1, 4
     row tiles on each rank's card) on 2 frames of 2160x3840 equal to the
     single-process stereo_sgm_sharded, and in exact mode to
     stereo_sgm_batch, bit for bit (the multiproc path: launches summed
     over the ranks, held to config 5's plan); (b) 16 config-2 frames, 8 a
     rank, equal to stereo_sgm_batch; (c) 2 config-4 flow frames of
     375x1242, one a rank, equal to flow_fsgm (validity and flow; the
     multiproc_flow path, held to twice phase 5's launches); each rank
     reports its launches, first call's wall, peak memory and loaded
     modules (none of jax, fsgm_tpu, golden), printed beside the
     single-process call's ms and peak; (d) `python -m fsgm_tpu_torch.cli
     scale-test --procs 2` for stereo and flow (exit 0, one JSON line,
     printed; ranks sharing one card give no weak-scaling figure); (e)
     tests/distributed/test_multihost.py's case (32x48, D=16, 4 row tiles
     a rank, exact) on 2 CPU ranks equal to stereo_sgm; (f)
     stereo_sgm_dsharded at config 2 on one KITTI frame over 4 label
     slices on this card and at 37x53, 16 paths, adaptive P2 over 2, each
     equal to stereo_sgm, timed; (g) dryrun_multichip(n) for n = 1, 2, 3,
     4, 8 on this card;
 12. batched flow: (a) K5 and K4 with a frame axis against their plain
     versions, exact, one launch each: on 8 config-4 level-0 frames
     (flow_pair seeds 0-7, their own priors, K2 over the 8 frames between),
     on 3 frames of random 4K level-0 label-major cost (3 x 2160 x 96 x
     3840 bytes, past 2^31) and on 2 frames of random 4K level-0 int16 S,
     and the 8 frames' K5 and K4 timed (event, device, plain, library,
     bound: the kernels line's "batch" entries of rows #10 and #13); (b)
     flow_fsgm_batch on the 8 config-4 frames equal bit for bit to
     per-frame flow_fsgm, frame 0 to flow_fsgm_reference (validity equal,
     flow within 1e-3), its launches held to the lockstep plan (the
     flow_batch path: one K5 and one K4 a level-pass whatever B is), and
     chunk=None's pass size from the card's free memory (3 4K frames do
     not go in one pass); (c)
     every fb_backward x fb_grid mode at 96x128 over 3 frames, batched
     (chunk None and 2) equal to per-frame flow_fsgm, launches held to the
     plan, frame 0 to flow_fsgm_reference; (d) utils/profiling.profile_flow
     at B = 1 and B = 8: wall and busy ms, busy share, device launches and
     kernel-wrapper launches a frame, peak memory; (e) `cli serve` with
     the flow preset: a flow_batch request over 2 pairs and a flow request,
     the .flo files equal to flow_fsgm;
 13. the tiled flow's frame axis (parallel/tiled_flow.py: a shard's frames
     as one pass through the row-tile chain, both passes of a level in
     lockstep): (a) the 4K flow leg over 2 frames (seeds 0, 1) at 3 row
     tiles, exact, in one pass (chunk=2), each frame equal bit for bit to
     flow_fsgm, its launches held to one pass's plan (tiled_flow_launches:
     15 K5, 120 K2, 15 K4 a call; the flow_tiled_batch path; phase 8(e)'s
     one-frame call is held to the same plan); (b) K5, K2 with carry and
     the 2D rule and K4 against their plain versions on those 2 frames'
     level-0 tile 1 as one (2, ...) stack; (c) config 4 on 8 frames as 2
     frame shards of one row tile, each shard equal bit for bit to
     flow_fsgm_batch, launches held to 2 x its plan; (d) 4 config-4 flow
     frames on 2 ranks sharing this card, 2 frames a rank, equal to the
     single-process flow_fsgm_sharded, launches summed over the ranks held
     to 2 x flow_fsgm_batch's plan over 2 frames; (e) CUDA-event ms per
     frame and peak MiB of (a) at N = 1 and 2 frames a pass, and the pass
     size chunk=None takes for 2 4K frames on this card.

Each kernel's bound_ms is the larger of two times for this run's shapes:
the bytes it must move (each input read once, each output written once;
label pad slots that no kernel reads are not counted) over 3.35 TB/s, and
its integer operations over 67e12 op/s (the H100's float32 rate outside the
tensor cores; the table of peaks has no int32 rate, so this bound is
generous).  The batched rows count the same per frame, times B.  K2's
family launch counts what the per-direction launches count for the same
directions (and an S read when it adds into a given S); wta_right 3
operations per S value (shift, or, min) and one int32 output per pixel;
min16_probe two inputs read and one output written, one operation per
value.
Operations per element: K1 3 (xor, popcount, select) per cost
byte; K2 8 per label and direction for 1D labels (two shuffled neighbours,
+P1, three mins, +C-m, the warp min), 11 for 2D labels (two more neighbour
mins); K3 6 per S value (two packed keys, two mins); K4 3 per S value
(shift, or, min); K5 none.  K2 with carry also reads and writes two
carry rows per direction; K3 on a window counts the window's columns.

The run fails if anything in it loaded a module of jax, fsgm_tpu or golden.
The last lines are the per-kernel JSON record, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

KITTI = (375, 1242, 128)
TSUKUBA = (288, 384, 64)
UHD = (2160, 3840, 128)   # configs/tiled_4k.json: S of 2 frames > 4 GiB
SMALL = (37, 53, 32)
BATCH = 16        # frames per stereo_sgm_batch call on the batched path
CLI_FRAMES = 4    # KITTI-size pairs through the batch CLI
REPO = Path(__file__).resolve().parent
FLOW_HW = (375, 1242)
FLOW_SMALL = (37, 53)
FLOW_LEVELS = tuple((FLOW_HW[0] >> k, FLOW_HW[1] >> k)
                    for k in range(4))  # config 4's pyramid: K5's shapes
FLOW_MAX_MAG = 8
SEED = 0
DISP_TOL = 1e-3  # f32 subpixel: both sides use the same IEEE formula
FLOW_TOL = 1e-3  # the float tail is the same torch code on both sides
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# kernel name: (csrc source, TPU kernel it replaces, the others, main
# paths); the kernels line's `launches` is the first path's count,
# launches_by_path all.  K2 is sgm_sweep and sgm_sweep_family on one KITTI
# frame (aggregate_paths' launch_plan on one H100: the vertical group per
# direction, the horizontal pair in one family launch), sgm_sweep_family on
# flow, sgm_sweep on 16 frames and on the tiled and multiproc paths.  The
# multiproc paths' counts are summed over phase 11's ranks.  wta_right and
# min16_probe are on no path: only phase 9 runs them.
SOURCES = {
    "census_cost": ("cost", "fsgm_tpu/ops/pallas/cost_tr.py:106",
                    ["fsgm_tpu/ops/pallas/cost_tr.py:264",
                     "fsgm_tpu/ops/pallas/cost_tr.py:158",
                     "fsgm_tpu/ops/pallas/cost_pallas.py:56"],
                    ("stereo", "stereo_batch", "stereo_tiled", "bench",
                     "kitti", "multiproc")),
    "sgm_sweep": ("sgm_sweep", "fsgm_tpu/ops/pallas/aggregate_tr.py:289",
                  ["fsgm_tpu/ops/pallas/aggregate_pallas.py:297",
                   "fsgm_tpu/ops/pallas/aggregate_pallas.py:420"],
                  ("stereo_batch", "stereo", "stereo_tiled", "flow_tiled",
                   "flow_tiled_batch", "bench", "kitti", "multiproc")),
    "sgm_sweep_family": ("sgm_sweep",
                         "fsgm_tpu/ops/pallas/aggregate_tr.py:451",
                         ["tools/trexp.py:102"],
                         ("stereo", "flow", "bench", "video", "kitti",
                          "multiproc_flow")),
    "extract_stereo": ("extract", "fsgm_tpu/ops/pallas/extract_tr.py:227",
                       ["fsgm_tpu/ops/pallas/extract_pallas.py:82"],
                       ("stereo", "stereo_batch", "stereo_tiled", "bench",
                        "kitti", "multiproc")),
    "wta_right": ("extract", "fsgm_tpu/ops/pallas/extract_tr.py:299",
                  ["tools/strideroll_probe.py:34",
                   "tools/strideroll_probe.py:59",
                   "tests/unit/test_property.py:142"], ()),
    "extract_flow": ("extract_flow", "fsgm_tpu/ops/pallas/extract_tr.py:387",
                     None, ("flow", "flow_batch", "flow_tiled",
                            "flow_tiled_batch", "bench", "video", "kitti",
                            "multiproc_flow")),
    "label_minor_from_major": (
        "transpose", "fsgm_tpu/ops/pallas/transpose_pallas.py:83", None,
        ("flow", "flow_batch", "flow_tiled", "flow_tiled_batch", "bench",
         "video", "kitti", "multiproc_flow")),
    "min16_probe": ("min16_probe", "tools/tr_int16_probe.py:41", None, ()),
}
PROBE_SHAPE = (376, 1280, 128)  # tools/strideroll_probe.py's H, W, L
MIN16_N = 1 << 26               # values per min16_probe input
CONFIG5 = "configs/tiled_4k.json"
UHD_FLOW_LEVELS = 5  # bench.py's 4kflow leg: config 4 with one more level
FOREIGN = ("jax", "fsgm_tpu", "golden")
VIDEO_FRAMES = 4        # constant_flow_sequence frames through `cli video`
KITTI_FRAMES = 2        # frames of each task in the written devkit tree
ENTRY_MOTION = (3, -2)  # (u, v) of the video and kitti flow frames
SGM_KERNELS = ("sgm_sweep", "sgm_sweep_family")  # K2's two launch forms
RANKS = 2               # torch.distributed ranks of phase 11, on one card
RANK_TIMEOUT_S = 300.0  # each launch of phase 11's ranks
DSHARD_TD = 4           # label slices of stereo_sgm_dsharded at KITTI
FLOW_BATCH = 8          # config-4 frames of phase 12's flow_fsgm_batch
UHD_K5_FRAMES = 3       # 4K level-0 label-major costs in one K5 (> 2^31 B)
UHD_K4_FRAMES = 2       # 4K level-0 int16 S in one K4
MODES_HW = (96, 128)    # phase 12's fb_backward x fb_grid frames
MODES_FRAMES = 3
UHD_FLOW_FRAMES = 2     # 4K flow frames of phase 13's tiled pass
SHARD_FRAMES = 2        # config-4 flow frames a shard (rank) in phase 13


def ptxas_record() -> dict:
    """-Xptxas -v of sgm_sweep.cu (kept beside its library by _build):
    registers, static shared memory and spill bytes of each K2
    instantiation, keyed kernel<K, S type, mode, 2D, packed> (the family
    kernel's mode is the atomic one), and the worst of each."""
    from fsgm_tpu_torch.ops.kernels import _build
    from fsgm_tpu_torch.utils.k2_bench import parse_ptxas
    kinds = {}
    for rec in parse_ptxas(_build.ptxas_log("sgm_sweep")):
        m = re.search(r"(sgm_(?:sweep|family)_kernel)ILi(\d+)E([si])(.*?)EEv",
                      rec["kernel"])
        if not m:
            continue
        flags = re.findall(r"L[ib](\d+)", m.group(4))
        mode = flags.pop(0) if m.group(1) == "sgm_sweep_kernel" else "2"
        name = (f"{m.group(1)}<K={m.group(2)},"
                f"{'int16' if m.group(3) == 's' else 'int32'},mode={mode},"
                f"2d={flags[0]},packed={flags[1]}>")
        kinds[name] = [rec["registers"], rec["smem"],
                       rec["spill_stores"] + rec["spill_loads"]]
    require(len(kinds) > 0, "no -Xptxas -v record for sgm_sweep.cu")
    worst = dict(instantiations=len(kinds),
                 max_registers=max(v[0] for v in kinds.values()),
                 max_smem=max(v[1] for v in kinds.values()),
                 spill_bytes=sum(v[2] for v in kinds.values()))
    print(f"ptxas sgm_sweep.cu [registers, smem bytes, spill bytes]: "
          f"{json.dumps(kinds)}; {json.dumps(worst)}")
    return dict(worst, main={k: v for k, v in kinds.items() if "K=4," in k
                             or "K=3,int16,mode=1,2d=1" in k})


def lib_ptxas_record() -> dict:
    """-Xptxas -v of cost.cu (K1), extract.cu (K3, wta_right),
    extract_flow.cu (K4), transpose.cu (K5) and min16_probe.cu: per library
    the instantiations, the worst registers, static shared memory and spill
    bytes, and the main path's instantiation [registers, smem, spill
    bytes]: K1 census_cost_kernel<NP=4, left, 32-bit words>, K3
    extract_kernel<K=4, int16, with the right view>, K4
    extract_flow_kernel<K=3, int16>, K5 transpose_tiled_kernel<G=6> (96
    label slots), min16_probe's packed form."""
    from fsgm_tpu_torch.ops.kernels import _build
    from fsgm_tpu_torch.utils.k2_bench import parse_ptxas
    main = {"cost": "census_cost_kernelILi4ELb0ELb1E",
            "extract": "extract_kernelILi4EsLi1E",
            "extract_flow": "extract_flow_kernelILi3EsE",
            "transpose": "transpose_tiled_kernelILi6EE",
            "min16_probe": "min_kernelILi3EE"}
    out = {}
    for lib, tag in main.items():
        recs = parse_ptxas(_build.ptxas_log(lib))
        require(len(recs) > 0, f"no -Xptxas -v record for {lib}.cu")
        hit = [r for r in recs if tag in r["kernel"]]
        require(len(hit) == 1, f"no main instantiation {tag} in {lib}.cu")
        out[lib] = dict(
            instantiations=len(recs),
            max_registers=max(r["registers"] for r in recs),
            max_smem=max(r["smem"] for r in recs),
            spill_bytes=sum(r["spill_stores"] + r["spill_loads"]
                            for r in recs),
            main=[hit[0]["registers"], hit[0]["smem"],
                  hit[0]["spill_stores"] + hit[0]["spill_loads"]])
    print(f"ptxas cost.cu, extract.cu, extract_flow.cu, transpose.cu and "
          f"min16_probe.cu: {json.dumps(out)}")
    return out


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def foreign_modules() -> list[str]:
    """Loaded modules of jax, the JAX package or golden/."""
    return sorted(m for m in sys.modules if m in FOREIGN
                  or m.startswith(tuple(r + "." for r in FOREIGN)))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps: int = 10, warmup: int = 2, inner: int = 1) -> float:
    """Median over reps of the ms of one fn() call, timed over ``inner``
    calls back to back (utils/card_timing.py)."""
    from fsgm_tpu_torch.utils import card_timing
    return card_timing.median_ms(fn, reps, warmup, inner)


def device_launches(fn) -> int:
    """Device kernels, memsets and copies of one fn() call (torch.profiler,
    after one warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def device_ms(fn, reps: int = 10) -> float | None:
    """torch.profiler's device time of one fn() call for a fn that launches
    each of its kernels once, after one warm-up call
    (utils/card_timing.py); None where no profile recorded a launch, so
    that the kernels line prints null and never a time it did not
    measure."""
    from fsgm_tpu_torch.utils import card_timing
    return card_timing.device_ms(fn, reps)


def ms_text(ms: float | None) -> str:
    """A measured ms for a log line, or "not recorded"."""
    return "not recorded" if ms is None else f"{ms:.4f} ms"


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for the given work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> int:
    """Largest |a - b|, frame by frame over a leading batch axis (the int64
    copies of a 16-frame KITTI volume would take 23 GB at once)."""
    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    pairs = zip(a, b) if a.dim() == 4 else [(a, b)]
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               for x, y in pairs)


def pair(h, w, d, seed, dev):
    from fsgm_tpu_torch.io import random_dot_stereo
    il, ir, gt = random_dot_stereo(h, w, d, seed=seed)
    return (torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev), gt)


def frame_stack(h, w, d, b, seed, dev, bleed: bool = False):
    """(B, H, W) left and right stacks of random-dot pairs (seeds seed ..
    seed + B - 1); with bleed, frame 0's last row bright and frame 1's
    first row dark in both views."""
    from fsgm_tpu_torch.io import random_dot_stereo
    pairs = [random_dot_stereo(h, w, d, seed=seed + k) for k in range(b)]
    il = np.stack([p[0] for p in pairs])
    ir = np.stack([p[1] for p in pairs])
    if bleed:
        il[0, -1], ir[0, -1] = 255, 255
        if b > 1:
            il[1, 0], ir[1, 0] = 0, 0
    return torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev)


def flow_pair(h, w, seed, dev):
    from fsgm_tpu_torch.io import blockwise_flow_pair
    i1, i2, gt, gt_valid = blockwise_flow_pair(h, w, FLOW_MAX_MAG, seed=seed)
    return (torch.from_numpy(i1).to(dev), torch.from_numpy(i2).to(dev), gt,
            gt_valid)


def check_kernels(shape, params, dev, dirs, tag: str) -> dict:
    """Each stereo kernel against its plain version on one input; returns
    the largest absolute error per kernel (all must be 0)."""
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.ops.kernels import cost, extract

    h, w, d = shape
    tl, tr, _ = pair(h, w, d, SEED, dev)
    cl = census_transform(tl, params.census_window)
    cr = census_transform(tr, params.census_window)
    # the main path's 32-bit words (census_bits) and the 64-bit path, both
    # references
    errs = {"census_cost": max(max_err(
        cost.census_cost(cl, cr, d, params.invalid_cost, rr, bits),
        cost.census_cost_plain(cl, cr, d, params.invalid_cost, rr, bits))
        for bits in (params.census_bits, 64) for rr in (False, True))}
    require(errs["census_cost"] == 0, f"{tag} census_cost != plain")
    c = cost.census_cost(cl, cr, d, params.invalid_cost, False,
                         params.census_bits)

    s_dtype = agg.plan_dtypes(params.s_invalid)
    cap = agg.p2_bound(params.p1, params.p2)
    sweep_err = 0
    for r in dirs:
        p2e = agg.p2_effective(tl, r, params.p1, params.p2,
                               params.adaptive_p2)
        want = agg.sgm_sweep_plain(c, p2e, r, params.p1)
        # with the P2' bound (packed labels where packed16 holds) and
        # without one (int32 labels)
        e = max(max_err(agg.sgm_sweep(c, p2e, r, params.p1, s_dtype=s_dtype,
                                      p2_max=p2_max), want)
                for p2_max in (cap, None))
        print(f"{tag} sgm_sweep direction {r}: max_abs_err {e}")
        require(e == 0, f"{tag} sgm_sweep {r} != plain")
        sweep_err = max(sweep_err, e)
    s = agg.aggregate_paths(c, tl, dirs, params.p1, params.p2,
                            params.adaptive_p2, params.s_invalid)
    s_ref = agg.aggregate_paths_plain(c, tl, dirs, params.p1, params.p2,
                                      params.adaptive_p2, params.s_invalid)
    e = max_err(s, s_ref)
    require(s.dtype == s_ref.dtype and e == 0, f"{tag} S != plain")
    errs["sgm_sweep"] = sweep_err
    for k2 in k2_launches(c.shape, dev, dirs, params):  # built S
        errs[k2] = max(errs.get(k2, 0), e)

    got = extract.extract_stereo(s, params.s_invalid, params.lr_max_diff,
                                 params.subpixel)
    want = extract.extract_stereo_plain(s, params.s_invalid,
                                        params.lr_max_diff, params.subpixel)
    names = ("d_int", "s_m", "s_0", "s_p", "valid")
    es = {n: max_err(a, b) for n, a, b in zip(names, got, want)}
    print(f"{tag} extract_stereo max_abs_err {es}")
    require(all(v == 0 for v in es.values()), f"{tag} extract != plain")
    errs["extract_stereo"] = max(es.values())
    print(f"{tag} kernels == plain (packed labels "
          f"{agg.packed16(s_dtype, d, params.p1, cap)}): {errs}")
    return errs


def check_extract_ties(dev) -> None:
    """K3 on an int32 volume full of ties and of values at s_invalid."""
    from fsgm_tpu_torch.ops.kernels import extract
    g = torch.Generator(device="cpu").manual_seed(SEED)
    s = torch.randint(0, 4, (24, 70, 64), generator=g, dtype=torch.int32)
    s[:, -20:, 40:] = 5000
    s = s.to(dev)
    got = extract.extract_stereo(s, 5000, 1, True)
    want = extract.extract_stereo_plain(s, 5000, 1, True)
    errs = [max_err(a, b) for a, b in zip(got, want)]
    require(all(e == 0 for e in errs), "extract ties != plain")
    print(f"extract ties/int32 volume: max_abs_err {errs}")


def check_batch_kernels(shape, b, params, dev, tag: str) -> dict:
    """K1 (left and right reference), K2 (each direction and the sum) and K3
    (with and without the right-view pass) over B frames against their
    plain versions; returns the largest absolute error per kernel."""
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.ops.kernels import cost, extract

    h, w, d = shape
    tl, tr = frame_stack(h, w, d, b, SEED, dev, bleed=True)
    cl = census_transform(tl, params.census_window)
    cr = census_transform(tr, params.census_window)
    k1 = 0
    for rr in (False, True):
        got = cost.census_cost(cl, cr, d, params.invalid_cost, rr,
                               params.census_bits)
        k1 = max(k1, max_err(got, cost.census_cost_plain(
            cl, cr, d, params.invalid_cost, rr, params.census_bits)))
        del got
    require(k1 == 0, f"{tag} batched census_cost != plain")
    c = cost.census_cost(cl, cr, d, params.invalid_cost)
    s_dtype = agg.plan_dtypes(params.s_invalid)
    k2 = 0
    for r in params.dirs:
        p2e = agg.p2_effective(tl, r, params.p1, params.p2,
                               params.adaptive_p2)
        got = agg.sgm_sweep(c, p2e, r, params.p1, s_dtype=s_dtype,
                            p2_max=agg.p2_bound(params.p1, params.p2))
        k2 = max(k2, max_err(got, agg.sgm_sweep_plain(c, p2e, r, params.p1)))
        del got
    require(k2 == 0, f"{tag} batched sgm_sweep != plain")
    s = agg.aggregate_paths(c, tl, params.dirs, params.p1, params.p2,
                            params.adaptive_p2, params.s_invalid)
    s_ref = agg.aggregate_paths_plain(c, tl, params.dirs, params.p1,
                                      params.p2, params.adaptive_p2,
                                      params.s_invalid)
    require(s.dtype == s_ref.dtype, f"{tag} batched S dtype")
    k2_sum = max_err(s, s_ref)
    require(k2_sum == 0, f"{tag} batched S != plain")
    del c, s_ref
    k3 = 0
    for with_rwta in (True, False):
        got = extract.extract_stereo(s, params.s_invalid, params.lr_max_diff,
                                     params.subpixel, with_rwta)
        want = extract.extract_stereo_plain(s, params.s_invalid,
                                            params.lr_max_diff,
                                            params.subpixel, with_rwta)
        require((got[4] is None) == (not with_rwta) == (want[4] is None),
                f"{tag} K3 validity plane with_rwta={with_rwta}")
        k3 = max([k3] + [max_err(a, x) for a, x in zip(got, want)
                         if a is not None])
    require(k3 == 0, f"{tag} batched extract_stereo != plain")
    errs = {"census_cost": k1, "sgm_sweep": k2, "extract_stereo": k3}
    for k2 in k2_launches((b, h, w, d), dev, params.dirs, params):  # S
        errs[k2] = max(errs.get(k2, 0), k2_sum)
    print(f"{tag} batched kernels == plain ({b} frames, S {s.dtype}): "
          f"{errs}")
    return errs


def check_batch_path(shape, b, params, dev, tag: str) -> dict:
    """stereo_sgm_batch on B frames, launches counted in that call only,
    equal to per-frame stereo_sgm bit for bit; the launch counts."""
    from fsgm_tpu_torch import stereo_sgm, stereo_sgm_batch
    from fsgm_tpu_torch.ops.kernels import _build

    h, w, d = shape
    tl, tr = frame_stack(h, w, d, b, SEED, dev)
    _build.LAUNCHES.clear()
    disp = stereo_sgm_batch(tl, tr, params)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"launches in one stereo_sgm_batch call ({tag}, {b} frames): "
          f"{launches}")
    want = {"census_cost": 1, **k2_launches((b, h, w, d), dev, params.dirs,
                                            params),
            "extract_stereo": 1}
    require(launches == want, f"{tag} batch launches {launches} != {want}")
    require(tuple(disp.shape) == (b, h, w) and disp.dtype == torch.float32
            and bool(torch.isfinite(disp).all()),
            f"{tag} batch shape / finiteness")
    per = torch.stack([stereo_sgm(tl[k], tr[k], params) for k in range(b)])
    require(torch.equal(disp, per), f"{tag} stereo_sgm_batch != per-frame")
    print(f"{tag}: stereo_sgm_batch ({b} frames) == per-frame stereo_sgm, "
          f"density {float((disp >= 0).float().mean()):.4f}")
    return launches


def check_lr_options(params, dev) -> None:
    """stereo_sgm with lr_mode="reagg" and with fill_invalid at config 2
    against stereo_sgm_reference, with the launches of each call."""
    from fsgm_tpu_torch import stereo_sgm, stereo_sgm_reference
    from fsgm_tpu_torch.eval import d1_all
    from fsgm_tpu_torch.ops.kernels import _build

    h, w, d = KITTI
    tl, tr, gt = pair(h, w, d, SEED, dev)
    for kw in (dict(lr_mode="reagg"), dict(fill_invalid=True)):
        q = dataclasses.replace(params, **kw)
        _build.LAUNCHES.clear()
        disp = stereo_sgm(tl, tr, q)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        ref = stereo_sgm_reference(tl, tr, q)
        require(bool(torch.isfinite(disp).all()), f"{kw} finiteness")
        require(torch.equal(disp < 0, ref < 0), f"{kw} invalid mask != plain")
        both = (disp >= 0) & (ref >= 0)
        err = float((disp[both] - ref[both]).abs().max())
        require(err <= DISP_TOL, f"{kw} disparity error {err}")
        m = d1_all(disp.cpu().numpy(), gt.astype(np.float64))
        print(f"stereo_sgm {kw} vs plain: invalid mask equal, max |disp "
              f"err| {err}; D1-all {m['d1_all']:.4f} density "
              f"{m['density']:.4f}; launches {launches}")


def run_cli(args, stdin: str | None = None, expect: int = 0) -> list[dict]:
    """python -m fsgm_tpu_torch.cli <args> on the card; its JSON lines."""
    proc = subprocess.run([sys.executable, "-m", "fsgm_tpu_torch.cli", *args,
                           "--device", "cuda"], cwd=REPO, input=stdin,
                          capture_output=True, text=True, timeout=600)
    require(proc.returncode == expect,
            f"cli {args[0]} exit {proc.returncode} != {expect}: "
            f"{proc.stderr[-2000:]}")
    return [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]


def check_cli(params, dev) -> None:
    """The batch CLI with a fault injection and the resume, and a serve
    stereo_batch request, on KITTI-size PNG pairs; every written disparity
    equal to stereo_sgm's within the PNG's 1/256 step."""
    from fsgm_tpu_torch import stereo_sgm
    from fsgm_tpu_torch.io import (load_gray, random_dot_stereo,
                                   read_disparity_png, save_gray)

    h, w, d = KITTI
    preset = str(REPO / "configs" / "kitti_stereo.json")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lines = []
        for k in range(CLI_FRAMES):
            il, ir, _ = random_dot_stereo(h, w, d, seed=SEED + 40 + k)
            save_gray(tmp / f"l{k}.png", il)
            save_gray(tmp / f"r{k}.png", ir)
            lines.append([str(tmp / f"l{k}.png"), str(tmp / f"r{k}.png"),
                          str(tmp / f"d{k}.png")])
        lst = tmp / "pairs.txt"
        lst.write_text("\n".join("\t".join(x) for x in lines) + "\n")
        args = ["batch", str(lst), "--manifest", str(tmp / "run.jsonl"),
                "--preset", preset, "--dispatch-batch", "2"]
        out = run_cli(args + ["--fault-inject", "2"], expect=17)
        require(out[-1] == {"cmd": "batch", "fault_injected": True,
                            "done": 2}, f"fault-inject record {out}")
        out = run_cli(args)
        require(out[-1] == {"cmd": "batch", "total": CLI_FRAMES,
                            "newly_done": CLI_FRAMES - 2, "skipped": 2},
                f"resume record {out}")
        reqs = [{"task": "stereo_batch", "id": "sb",
                 "pairs": [[a, b, o.replace(".png", "_s.png")]
                           for a, b, o in lines[:2]]},
                {"task": "stereo", "id": "s", "left": lines[2][0],
                 "right": lines[2][1], "out": str(tmp / "single.png")}]
        out = run_cli(["serve", "--preset", preset, "--pipeline", "1"],
                      stdin="".join(json.dumps(r) + "\n" for r in reqs)
                      + "\n")
        require([r.get("id") for r in out[1:-1]] == ["sb", "s"]
                and all("error" not in r for r in out),
                f"serve responses {out}")
        written = [(x[2], x) for x in lines]
        written += [(x[2].replace(".png", "_s.png"), x) for x in lines[:2]]
        written.append((str(tmp / "single.png"), lines[2]))
        worst = 0.0
        for path, (a, b, _) in written:
            want = stereo_sgm(torch.tensor(load_gray(a), device=dev),
                              torch.tensor(load_gray(b), device=dev),
                              params).cpu().numpy()
            got = read_disparity_png(path)
            require(np.array_equal(got < 0, want < 0), f"{path} mask")
            worst = max(worst, float(np.abs(got - want)[want >= 0].max()))
        require(worst <= 1 / 256, f"CLI disparity error {worst}")
    print(f"cli batch (fault-inject after 2, resume of {CLI_FRAMES - 2}) and "
          f"serve stereo_batch + stereo on {h}x{w} PNGs: {len(written)} "
          f"outputs == stereo_sgm within {worst} (PNG step 1/256)")


def flow_level(hw, params, dev, frames: int | None = None,
               seed: int = SEED) -> dict:
    """One flow level as the main path builds it, on a blockwise pair with a
    non-zero prior (the ground truth, rounded, plus integer noise in
    [-2, 2] from the seed): census, label-major cost padded to a multiple
    of 32, and the P2' tables of the 8 directions.  With ``frames``, that
    many pairs (seeds seed ... seed + frames - 1) stacked on a leading
    axis, as the batched path builds a level over its slices."""
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.cost import cost_volume_flow_major
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.params import DIRS_8

    h, w = hw
    got = []
    for k in range(seed, seed + (frames or 1)):
        t1, t2, gt, _ = flow_pair(h, w, k, dev)
        rng = np.random.default_rng(k)
        prior = np.rint(gt) + rng.integers(-2, 3, gt.shape)
        got.append((t1, t2) + tuple(
            torch.from_numpy(prior[..., k].astype(np.int32)).to(dev)
            for k in (0, 1)))
    t1, t2, bu, bv = (torch.stack(x) if frames else x[0]
                      for x in zip(*got))
    require(bool((bu != 0).any() and (bv != 0).any()), "prior is zero")
    nl = params.num_labels
    cen1 = census_transform(t1, params.census_window)
    cen2 = census_transform(t2, params.census_window)
    cost_m = cost_volume_flow_major(cen1, cen2, bu, bv, params.search_radius,
                                    params.invalid_cost,
                                    nl_pad=-(-nl // 32) * 32)
    p2es = [agg.p2_effective(t1, r, params.p1, params.p2, params.adaptive_p2)
            for r in DIRS_8]
    return dict(img=t1, img2=t2, cost_m=cost_m, p2es=p2es, dirs=DIRS_8,
                nl=nl, e=params.window_extent, p1=params.p1,
                p2_max=agg.p2_bound(params.p1, params.p2),
                s_dtype=agg.plan_dtypes(8 * (params.invalid_cost
                                             + params.p2)))


def flow_sweeps(lv, cost, plain: bool = False):
    """The level's 8 sweeps over prebuilt P2' tables: S."""
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    if plain:
        return sum(agg.sgm_sweep_plain(cost, p2e, r, lv["p1"], lv["e"],
                                       lv["nl"])
                   for r, p2e in zip(lv["dirs"], lv["p2es"])
                   ).to(lv["s_dtype"])
    s = None
    for r, p2e in zip(lv["dirs"], lv["p2es"]):
        s = agg.sgm_sweep(cost, p2e, r, lv["p1"], s=s, s_dtype=lv["s_dtype"],
                          label_ext=lv["e"], nl=lv["nl"], p2_max=lv["p2_max"])
    return s


def k4_err(s, nl, e, tag: str) -> int:
    """K4 with and without subpixel against its plain version on S; the
    largest absolute error (must be 0)."""
    from fsgm_tpu_torch.ops.kernels import extract
    k4 = 0
    for with_sub in (True, False):
        got = extract.extract_flow(s, nl, e, with_sub)
        want = extract.extract_flow_plain(s, nl, e, with_sub)
        got = (got[0],) + (got[1] + got[2] if with_sub else ())
        want = (want[0],) + (want[1] + want[2] if with_sub else ())
        k4 = max([k4] + [max_err(a, b) for a, b in zip(got, want)])
    require(k4 == 0, f"{tag} extract_flow != plain")
    return k4


def check_flow_kernels(hw, params, dev, tag: str) -> dict:
    """K5, K2 (2D rule, each direction and the sum) and K4 (with and
    without subpixel) against their plain versions on one flow level;
    returns the largest absolute error per kernel (all must be 0)."""
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.ops.kernels import transpose

    lv = flow_level(hw, params, dev)
    c = transpose.label_minor_from_major(lv["cost_m"])
    errs = {"label_minor_from_major": max_err(
        c, transpose.label_minor_from_major_plain(lv["cost_m"]))}
    require(errs["label_minor_from_major"] == 0, f"{tag} K5 != plain")
    sweep_err = 0
    for r, p2e in zip(lv["dirs"], lv["p2es"]):
        got = agg.sgm_sweep(c, p2e, r, lv["p1"], s_dtype=lv["s_dtype"],
                            label_ext=lv["e"], nl=lv["nl"])
        want = agg.sgm_sweep_plain(c, p2e, r, lv["p1"], lv["e"], lv["nl"])
        e = max_err(got, want)
        require(e == 0, f"{tag} sgm_sweep 2D {r} != plain")
        sweep_err = max(sweep_err, e)
    s = flow_sweeps(lv, c)
    s_ref = flow_sweeps(lv, c, plain=True)
    e = max_err(s, s_ref)
    require(s.dtype == s_ref.dtype and e == 0, f"{tag} flow S != plain")
    errs["sgm_sweep"] = max(sweep_err, e)
    errs["extract_flow"] = k4_err(s, lv["nl"], lv["e"], tag)
    print(f"{tag} flow kernels == plain (S {s.dtype}, "
          f"{tuple(c.shape)} label-minor cost): {errs}")
    return errs


def check_k5_levels(dev) -> dict:
    """K5 against its plain version on random bytes at config 4's four
    level shapes (96 label slots); the largest absolute error (must be
    0)."""
    from fsgm_tpu_torch.ops.kernels import transpose
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = 0
    for h, w in FLOW_LEVELS:
        vol = torch.randint(0, 256, (h, 96, w), generator=gen, device=dev,
                            dtype=torch.uint8)
        err = max(err, max_err(transpose.label_minor_from_major(vol),
                               transpose.label_minor_from_major_plain(vol)))
    require(err == 0, "K5 != plain at a config-4 level shape")
    print(f"K5 == plain at config 4's level shapes {FLOW_LEVELS} x 96")
    return {"label_minor_from_major": err}


def merge_errs(*dicts) -> dict:
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = max(out.get(k, 0), v)
    return out


def carry_case(cost, img, rows, dirs, p1, p2, adaptive, s_dtype, tag,
               label_ext=None, nl=None, with_s: bool = False):
    """K2 with carry in and out on the tile cost[..., lo:hi, :, :] against
    sgm_sweep_plain, each vertical direction from the carry K2 exported
    over the rows above (down) or below (up) the tile, with the image rows
    beyond its seams as the P2' halos; the largest absolute error, and
    with ``with_s`` also the kernel's S summed over those directions."""
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    h = cost.shape[-3]
    lo, hi = rows
    kw = dict(s_dtype=s_dtype, label_ext=label_ext, nl=nl,
              p2_max=agg.p2_bound(p1, p2))

    def part(a, b, r):
        p2e = agg.p2_effective(img[..., a:b, :].contiguous(), r, p1, p2,
                               adaptive,
                               img[..., a - 2:a, :] if a >= 2 else None,
                               img[..., b:b + 2, :] if b + 2 <= h else None)
        return cost[..., a:b, :, :].contiguous(), p2e

    worst, s_sum = 0, None
    for r in [q for q in dirs if q[0] != 0]:
        c, p2e = part(*((0, lo) if r[0] > 0 else (hi, h)), r)
        carry = agg.sgm_sweep(c, p2e, r, p1, return_carry=True, **kw)[1]
        c, p2e = part(lo, hi, r)
        got = agg.sgm_sweep(c, p2e, r, p1, init_carry=carry,
                            return_carry=True, **kw)
        want = agg.sgm_sweep_plain(c, p2e, r, p1, label_ext, nl, carry,
                                   return_carry=True)
        e = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        require(e == 0, f"{tag} sgm_sweep with carry {r} != plain ({e})")
        worst = max(worst, e)
        if with_s:
            s_sum = got[0] if s_sum is None else s_sum + got[0]
        del got, want
    print(f"{tag}: K2 with carry == plain on rows {lo}..{hi - 1} "
          f"({tuple(cost.shape)}), max_abs_err {worst}")
    return (worst, s_sum) if with_s else worst


def kitti_windows(params, dev):
    """KITTI's two column windows at tiles_x = 2 (config 2, auto margin):
    [(window left, window right, gx0)], the images gathered and edge-
    repeated as the tiled path does."""
    from fsgm_tpu_torch import DistParams
    from fsgm_tpu_torch.parallel import tiled
    h, w, d = KITTI
    tl, tr, _ = pair(h, w, d, SEED, dev)
    ex = tiled.window_extension(params, DistParams(tiles_x=2))
    wt = w // 2
    rows = [[x[None, :, k * wt:(k + 1) * wt] for k in range(2)]
            for x in (tl, tr)]
    return [(tiled._window(rows[0], k, ex, None),
             tiled._window(rows[1], k, ex, None), k * wt - ex)
            for k in range(2)]


def window_s(wl, wr, gx0, params):
    """S of a column window in global columns (K1, the cost's global
    masking, K2 over the window)."""
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.ops.kernels import cost
    from fsgm_tpu_torch.parallel import tiled
    c = cost.census_cost(census_transform(wl, params.census_window),
                         census_transform(wr, params.census_window),
                         params.max_disp, params.invalid_cost)
    c = tiled._globalize_cost(c, gx0, KITTI[1], params.invalid_cost, False)
    return agg.aggregate_paths(c, wl, params.dirs, params.p1, params.p2,
                               params.adaptive_p2, params.s_invalid)


def check_tiled_kernels(params, dev) -> dict:
    """8(a) K2 with carry and 8(b) K3 with window columns against their
    plain versions; the largest absolute error per kernel."""
    from fsgm_tpu_torch import DIRS_8, FlowParams, SGMParams, load_preset
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.ops.kernels import cost, extract, transpose

    p5 = load_preset(CONFIG5)["sgm"]
    h, w, d = UHD
    ht = h // load_preset(CONFIG5)["dist"].tiles_y
    tl, tr = frame_stack(h, w, d, 2, SEED, dev)
    c = cost.census_cost(census_transform(tl, p5.census_window),
                         census_transform(tr, p5.census_window), d,
                         p5.invalid_cost)
    k2 = carry_case(c, tl, (ht, 2 * ht), p5.dirs, p5.p1, p5.p2,
                    p5.adaptive_p2, agg.plan_dtypes(p5.s_invalid),
                    "config-5 tile 540x3840x128, 2 frames")
    del c, tl, tr
    small = SGMParams(max_disp=SMALL[2], p1=7, p2=60, adaptive_p2=True,
                      num_paths=16)
    sl, sr = frame_stack(*SMALL, 2, SEED, dev, bleed=True)
    c = cost.census_cost(census_transform(sl), census_transform(sr),
                         SMALL[2])
    for rows in ((12, 25), (12, 13)):
        k2 = max(k2, carry_case(c, sl, rows, small.dirs, small.p1, small.p2,
                                True, agg.plan_dtypes(small.s_invalid),
                                "37x53x32 16-path adaptive, 2 frames"))
    fsmall = FlowParams(search_radius=2, levels=3, adaptive_p2=True)
    lv = flow_level(FLOW_SMALL, fsmall, dev)
    k2 = max(k2, carry_case(transpose.label_minor_from_major(lv["cost_m"]),
                            lv["img"], (12, 25), DIRS_8, fsmall.p1,
                            fsmall.p2, True, lv["s_dtype"],
                            "37x53 flow radius 2 (2D labels, 25 in 32)",
                            label_ext=lv["e"], nl=lv["nl"]))
    k3 = 0
    windows = [(window_s(wl, wr, gx0, params), gx0, KITTI[1])
               for wl, wr, gx0 in kitti_windows(params, dev)]
    g = torch.Generator(device="cpu").manual_seed(SEED)
    ties = torch.randint(0, 4, (24, 40, 64), generator=g, dtype=torch.int32)
    windows += [(ties.to(dev), -9, 30), (ties.to(dev), 5, 20)]
    for s, gx0, w_global in windows:
        for with_rwta in (True, False):
            got = extract.extract_stereo(s, params.s_invalid,
                                         params.lr_max_diff, params.subpixel,
                                         with_rwta, gx0, w_global)
            want = extract.extract_stereo_plain(
                s, params.s_invalid, params.lr_max_diff, params.subpixel,
                with_rwta, gx0, w_global)
            k3 = max([k3] + [max_err(a, b) for a, b in zip(got, want)
                             if a is not None])
        require(k3 == 0, f"extract_stereo window gx0={gx0} != plain")
        print(f"K3 on a window {tuple(s.shape)}, gx0 {gx0}, w_global "
              f"{w_global}: == plain (max_abs_err {k3})")
    return {"sgm_sweep": k2, "extract_stereo": k3}


def check_config5(dev) -> dict:
    """8(c): config 5 as the preset gives it against its plain twin, and in
    exact mode against stereo_sgm_batch, on its 2 frames; the tiled path's
    launches."""
    from fsgm_tpu_torch import (load_preset, stereo_sgm_batch,
                                stereo_sgm_sharded,
                                stereo_sgm_sharded_reference)
    from fsgm_tpu_torch.ops.kernels import _build

    preset = load_preset(CONFIG5)
    params, dist = preset["sgm"], preset["dist"]
    h, w, d = UHD
    tl, tr = frame_stack(h, w, d, 2, SEED, dev)
    want = stereo_sgm_batch(tl, tr, params)
    counters = {}
    _build.LAUNCHES.clear()
    got = stereo_sgm_sharded(tl, tr, params, dist, counters=counters)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    tiles = dist.frame_shards * dist.tiles_y
    # two passes per vertical direction, but for the family's first tile
    n_v = sum(1 for r in params.dirs if r[0] != 0)
    sweeps = tiles * (len(params.dirs) + n_v) - dist.frame_shards * n_v
    print(f"launches in one stereo_sgm_sharded call (config 5, {dist}): "
          f"{launches}; counters: rows "
          f"{ {k: sum(v) for k, v in counters['rows'].items()} }, bytes "
          f"{counters['bytes']}")
    require(launches == {"census_cost": tiles, "sgm_sweep": sweeps,
                         "extract_stereo": tiles},
            f"config-5 tiled launches {launches}")
    require(tuple(got.shape) == (2, h, w) and bool(torch.isfinite(got).all()),
            "config-5 tiled shape / finiteness")
    # the plain twin runs the plain K1, K2 and K3 on the same tiles
    ref = stereo_sgm_sharded_reference(tl, tr, params, dist)
    require(torch.equal(got, ref), "config-5 fast != its plain twin")
    differ = float((got != want).float().mean())
    print(f"config 5 tiled (fast, auto margin) == "
          f"stereo_sgm_sharded_reference bit for bit; differs from "
          f"stereo_sgm_batch at {differ} of the pixels")
    exact = dataclasses.replace(dist, tile_mode="exact")
    require(torch.equal(stereo_sgm_sharded(tl, tr, params, exact), want),
            "config-5 exact tiled != stereo_sgm_batch")
    print("config 5 tiled, exact mode == stereo_sgm_batch bit for bit")
    return launches


def check_kitti_tiled(params, dev) -> None:
    """8(d): KITTI at 3 row tiles."""
    from fsgm_tpu_torch import (DistParams, stereo_sgm, stereo_sgm_sharded,
                                stereo_sgm_sharded_reference)
    h, w, d = KITTI
    tl, tr, _ = pair(h, w, d, SEED, dev)
    il, ir = tl[None], tr[None]
    want = stereo_sgm(tl, tr, params)
    got = stereo_sgm_sharded(il, ir, params, DistParams(tiles_y=3,
                                                        tiles_x=2))[0]
    require(torch.equal(got, want), "KITTI ty=3 x tx=2 exact != stereo_sgm")
    fast = DistParams(tiles_y=3, tile_mode="fast", margin=8)
    got = stereo_sgm_sharded(il, ir, params, fast)
    require(torch.equal(got, stereo_sgm_sharded_reference(il, ir, params,
                                                          fast)),
            "KITTI ty=3 fast margin 8 != stereo_sgm_sharded_reference")
    differ = float((got[0] != want).float().mean())
    reagg = dataclasses.replace(params, lr_mode="reagg")
    require(torch.equal(stereo_sgm_sharded(il, ir, reagg,
                                           DistParams(tiles_y=3))[0],
                        stereo_sgm(tl, tr, reagg)),
            "KITTI ty=3 reagg != stereo_sgm")
    print(f"KITTI tiled: ty=3 x tx=2 exact == stereo_sgm; ty=3 fast margin "
          f"8 == plain twin (differs from untiled at {differ} of the "
          f"pixels); ty=3 reagg == stereo_sgm")


def uhd_flow(dev):
    """The 4K flow leg: config 4 with 5 levels and fb_grid "full", its
    pair, and the 3-row-tile distribution."""
    from fsgm_tpu_torch import DistParams, load_preset
    fp = dataclasses.replace(load_preset("configs/kitti_flow.json")["flow"],
                             levels=UHD_FLOW_LEVELS, fb_grid="full")
    f1, f2, _, _ = flow_pair(UHD[0], UHD[1], SEED, dev)
    return fp, f1, f2, DistParams(tiles_y=3)


def check_uhd_flow_tile(dev, frames: int | None = None) -> dict:
    """8(e) kernels at the tiled flow path's largest shape: K5, K2 with the
    2D rule and carries, and K4 against their plain versions on level-0
    tile 1 of the 4K flow leg (rows 720..1439 of 2160x3840, 81 labels in
    96 slots, non-zero prior), the carries from the tiles above (down) and
    below (up); the largest absolute error per kernel (all must be 0).
    13(b): with ``frames``, the tile of that many frames (seeds SEED ...)
    as one (N, ...) stack, as the tiled pass runs it (each frame's level
    built on its own: one 4K cost build's temporaries are ~27 GB)."""
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.ops.kernels import transpose
    fp, _, _, dist = uhd_flow(dev)
    if frames:
        lvs = [flow_level(UHD[:2], fp, dev, seed=SEED + k)
               for k in range(frames)]
        lv = dict(lvs[0], img=torch.stack([x["img"] for x in lvs]),
                  cost_m=torch.stack([x.pop("cost_m") for x in lvs]),
                  p2es=[torch.stack(t) for t in zip(*(x["p2es"]
                                                      for x in lvs))])
        del lvs
    else:
        lv = flow_level(UHD[:2], fp, dev)
    ht = UHD[0] // dist.tiles_y
    lo, hi = ht, 2 * ht
    tag = f"4K flow level-0 tile rows {lo}..{hi - 1}" + (
        f" of {frames} frames" if frames else "")
    tile_m = lv["cost_m"][..., lo:hi, :, :].contiguous()
    c_tile = transpose.label_minor_from_major(tile_m)
    errs = {"label_minor_from_major": max_err(
        c_tile, transpose.label_minor_from_major_plain(tile_m))}
    require(errs["label_minor_from_major"] == 0, f"{tag}: K5 != plain")
    c = transpose.label_minor_from_major(lv.pop("cost_m"))
    del tile_m
    errs["sgm_sweep"], s = carry_case(
        c, lv["img"], (lo, hi), lv["dirs"], lv["p1"], fp.p2, fp.adaptive_p2,
        lv["s_dtype"], f"{tag} (2D labels, {lv['nl']} in {c.shape[-1]})",
        label_ext=lv["e"], nl=lv["nl"], with_s=True)
    del c
    for r, p2e in zip(lv["dirs"], lv["p2es"]):
        if r[0] == 0:
            s = agg.sgm_sweep(c_tile, p2e[..., lo:hi, :].contiguous(), r,
                              lv["p1"],
                              s=s, s_dtype=lv["s_dtype"], label_ext=lv["e"],
                              nl=lv["nl"], p2_max=lv["p2_max"])
    errs["extract_flow"] = k4_err(s, lv["nl"], lv["e"], tag)
    print(f"{tag}: K5, K2 with carry and K4 (S {s.dtype} "
          f"{tuple(s.shape)}) == plain: {errs}")
    return errs


def tiled_flow_launches(fparams, tiles: int) -> dict:
    """{kernel: launches} of one pass of flow_fsgm_sharded in exact mode on
    a chain of ``tiles`` row tiles, whatever its frame count: on each tile
    one K5, 8 sgm_sweep launches (the two horizontal directions, and the
    three of each vertical family with its carry) and one K4 a level-pass;
    the level-passes as flow_launches counts them (a level's forward and
    backward passes are one, "single" adds its backward level, the last
    level of "cheap" extracts each half apart)."""
    mode = fparams.fb_backward if fparams.fb_check else None
    passes = fparams.levels + (mode == "single")
    split = mode == "cheap" and (fparams.subpixel or fparams.median_filter)
    return {"label_minor_from_major": tiles * passes,
            "sgm_sweep": 8 * tiles * passes,
            "extract_flow": tiles * (passes + split)}


def uhd_flow_frames(dev, frames: int):
    """``frames`` 4K flow pairs (seeds SEED ...) stacked: (N, H, W) each."""
    return (torch.stack(x) for x in zip(*[
        flow_pair(UHD[0], UHD[1], SEED + k, dev)[:2]
        for k in range(frames)]))


def check_uhd_flow(dev, frames: int = 1) -> dict:
    """8(e): the 4K flow leg tiled (exact) against flow_fsgm; the tiled
    flow path's launches, held to one pass's plan (tiled_flow_launches).
    13(a): ``frames`` frames in one pass (chunk=frames: chunk=None
    reckons one 4K frame a pass on an 80 GB card), each frame bit for bit
    flow_fsgm, the launches those of one pass: the flow_tiled_batch
    path."""
    from fsgm_tpu_torch import flow_fsgm, flow_fsgm_sharded
    fp, _, _, dist = uhd_flow(dev)
    i1, i2 = uhd_flow_frames(dev, frames)
    counters = {}
    (got, valid), launches = counted(lambda: flow_fsgm_sharded(
        i1, i2, fp, dist, counters=counters, chunk=frames))
    print(f"launches in one flow_fsgm_sharded call (4K, {frames} frames, "
          f"{dist}): {launches}; bytes handed between tiles "
          f"{counters['bytes']}")
    want_n = tiled_flow_launches(fp, dist.tiles_y)
    require(launches == want_n, f"4K tiled flow x {frames} launches "
            f"{launches} != one pass's plan {want_n}")
    for k in range(frames):
        want, want_valid = flow_fsgm(i1[k], i2[k], fp)
        require(torch.equal(got[k], want)
                and torch.equal(valid[k], want_valid),
                f"4K tiled flow frame {k} of {frames} != flow_fsgm")
    require(bool(valid.any()), "4K tiled flow: no valid pixel")
    print(f"4K flow tiled (3 row tiles, exact, {fp.levels} levels, {frames} "
          f"frames a pass) == flow_fsgm bit for bit; launches == one pass's "
          f"plan; valid share {float(valid.float().mean()):.4f}")
    return launches


def time_peak(fn, frames: int, reps: int = 3) -> dict:
    """CUDA-event ms per frame (median of reps after a warm-up) and the
    peak allocation of one call in MiB."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    return dict(ms=median_ms(fn, reps=reps, warmup=0) / frames,
                peak_mib=peak)


def time_tiled(params, dev, card_line: str) -> dict:
    """8(f): the tiled paths' ms per frame and peak memory beside their
    untiled counterparts, and the times of K2 with carry on a config-5
    tile and of K3 on a KITTI window, with their bounds."""
    from fsgm_tpu_torch import (flow_fsgm, flow_fsgm_sharded, load_preset,
                                stereo_sgm_batch, stereo_sgm_sharded)
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.ops.kernels import cost, extract

    preset = load_preset(CONFIG5)
    p5, dist = preset["sgm"], preset["dist"]
    h, w, d = UHD
    tl, tr = frame_stack(h, w, d, 2, SEED, dev)
    e2e = {
        "stereo_tiled_fast": time_peak(
            lambda: stereo_sgm_sharded(tl, tr, p5, dist), 2),
        "stereo_tiled_exact": time_peak(lambda: stereo_sgm_sharded(
            tl, tr, p5, dataclasses.replace(dist, tile_mode="exact")), 2),
        "stereo_batch": time_peak(lambda: stereo_sgm_batch(tl, tr, p5), 2)}
    for k, v in e2e.items():
        print(f"time {k} (config 5, 2 frames of {h}x{w}x{d}): "
              f"{v['ms']:.4f} ms/frame, peak {v['peak_mib']:.1f} MiB "
              f"({card_line})")
    fp, f1, f2, fdist = uhd_flow(dev)
    flow_t = {
        "flow_tiled": time_peak(lambda: flow_fsgm_sharded(
            f1[None], f2[None], fp, fdist), 1),
        "flow": time_peak(lambda: flow_fsgm(f1, f2, fp), 1)}
    for k, v in flow_t.items():
        print(f"time {k} (4K flow, {fp.levels} levels, 3 row tiles when "
              f"tiled): {v['ms']:.4f} ms/frame, peak {v['peak_mib']:.1f} "
              f"MiB ({card_line})")
    e2e.update(flow_t)
    del f1, f2

    # K2 with carry: the six vertical directions of tile 1 of config 5
    ht = h // dist.tiles_y
    c = cost.census_cost(census_transform(tl[:, ht:2 * ht].contiguous()),
                         census_transform(tr[:, ht:2 * ht].contiguous()), d,
                         p5.invalid_cost)
    b = c.shape[0]
    vert = [r for r in p5.dirs if r[0] != 0]
    p2es = [agg.p2_effective(tl[:, ht:2 * ht], r, p5.p1, p5.p2,
                             p5.adaptive_p2) for r in vert]
    g = torch.Generator(device="cpu").manual_seed(SEED)
    carries = [torch.randint(0, 300, (b, 2, w, d), generator=g,
                             dtype=torch.int32).to(dev) for _ in vert]
    s_dtype = agg.plan_dtypes(p5.s_invalid)
    p2_max = agg.p2_bound(p5.p1, p5.p2)

    def family(plain: bool = False):
        sweep = agg.sgm_sweep_plain_into if plain else agg.sgm_sweep
        s = None
        for r, p2e, cin in zip(vert, p2es, carries):
            s, _ = sweep(c, p2e, r, p5.p1, s=s, s_dtype=s_dtype,
                         init_carry=cin, return_carry=True, p2_max=p2_max)
        return s

    hwd = b * ht * w * d
    s_bytes = torch.tensor([], dtype=s_dtype).element_size()
    carry_b = len(vert) * 2 * b * 2 * w * d * 4
    nbytes = hwd + len(vert) * b * ht * w * 4 + hwd * s_bytes + carry_b
    nops = 8 * len(vert) * hwd
    b_ms, b_by = bound(nbytes, nops)
    carry_row = dict(shape=[b, ht, w, d], launches=len(vert),
                     ms=median_ms(family, reps=5, warmup=1),
                     plain_ms=median_ms(lambda: family(True), reps=1,
                                        warmup=0),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"time sgm_sweep with carry ({len(vert)} vertical directions of a "
          f"config-5 tile {(b, ht, w, d)}): kernel {carry_row['ms']:.4f} ms, "
          f"plain {carry_row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by "
          f"{b_by} ({nbytes} B, {nops} ops) ({card_line})")

    # the horizontal directions of the same tile in one frame, as a shard
    # of config 5 (one frame per shard) runs them
    horiz = [r for r in p5.dirs if r[0] == 0]
    c1 = c[:1].contiguous()
    p2h = [agg.p2_effective(tl[:1, ht:2 * ht], r, p5.p1, p5.p2,
                            p5.adaptive_p2) for r in horiz]

    def rows_sweeps(plain: bool = False):
        sweep = agg.sgm_sweep_plain_into if plain else agg.sgm_sweep
        s = None
        for r, p2e in zip(horiz, p2h):
            s = sweep(c1, p2e, r, p5.p1, s=s, s_dtype=s_dtype, p2_max=p2_max)
        return s

    e = max_err(rows_sweeps(), rows_sweeps(True))
    require(e == 0, f"config-5 tile horizontal sweeps != plain ({e})")
    hwd1 = ht * w * d
    nbytes = hwd1 + len(horiz) * ht * w * 4 + hwd1 * s_bytes
    b_ms, b_by = bound(nbytes, 8 * len(horiz) * hwd1)
    horiz_row = dict(shape=[1, ht, w, d], launches=len(horiz),
                     ms=median_ms(rows_sweeps, reps=5, warmup=1),
                     plain_ms=median_ms(lambda: rows_sweeps(True), reps=1,
                                        warmup=0),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"time sgm_sweep horizontal ({len(horiz)} directions of a config-5 "
          f"tile of one frame {(1, ht, w, d)}): kernel "
          f"{horiz_row['ms']:.4f} ms, plain {horiz_row['plain_ms']:.4f} ms, "
          f"bound {b_ms:.4f} ms by {b_by} ({card_line})")
    del c, c1, p2es, p2h, carries

    wl, wr, gx0 = kitti_windows(p5, dev)[0]
    s = window_s(wl, wr, gx0, p5)
    args = (s, p5.s_invalid, p5.lr_max_diff, p5.subpixel, True, gx0,
            KITTI[1])
    wc = s.shape[-2]
    nbytes = KITTI[0] * wc * (d * s.element_size() + 5 * 4)
    b_ms, b_by = bound(nbytes, 6 * KITTI[0] * wc * d)
    window_row = dict(shape=list(s.shape), gx0=gx0,
                      ms=median_ms(lambda: extract.extract_stereo(*args)),
                      plain_ms=median_ms(
                          lambda: extract.extract_stereo_plain(*args)),
                      bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"time extract_stereo on a KITTI window {tuple(s.shape)} (gx0 "
          f"{gx0}): kernel {window_row['ms']:.4f} ms, plain "
          f"{window_row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
          f"({card_line})")
    print(f"tiled paths per frame: {json.dumps(e2e)} ({card_line})")
    return dict(e2e=e2e, carry=carry_row, tile_horizontal=horiz_row,
                window=window_row)


def k2_launches(shape, dev, dirs, params, s_max=None,
                label_ext=None) -> dict:
    """{kernel: launches} of one aggregate_paths call for a cost volume of
    shape ((H, W, D) or (B, H, W, D)) on dev's card with params' P1 and P2
    (and S bound s_max, default params.s_invalid): one sgm_sweep_family
    launch for each direction group that launch_plan gives to the family
    launch, one sgm_sweep launch for each direction of the others."""
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    plan = agg.launch_plan(shape, dev, dirs, params.p1, params.p2,
                           params.s_invalid if s_max is None else s_max,
                           label_ext)
    out = {"sgm_sweep_family": sum(1 for _, fam in plan if fam),
           "sgm_sweep": sum(len(g) for g, fam in plan if not fam)}
    return {k: n for k, n in out.items() if n}


def flow_launches(img, fparams, dev, frames: int = 1) -> dict:
    """{kernel: launches} of one flow_fsgm_batch call over ``frames`` frames
    of img's shape (flow_fsgm: frames = 1), as models/flow.py runs the
    pyramid: one level-pass (one K5, one aggregate_paths plan, one K4) per
    level, over 2 x frames slices where the backward pass runs beside the
    forward one (every level under fb_backward full and cheap, levels >= 1
    under half) and over frames slices elsewhere; "single" adds one
    backward level-pass at level 0 over frames slices; the last level of
    "cheap" extracts each half apart (two K4 launches) where its params
    differ.  K2's launches are aggregate_paths' (k2_launches) for each
    level-pass's slices."""
    from fsgm_tpu_torch.models.flow import build_pyramid
    from fsgm_tpu_torch.params import DIRS_8
    nd = -(-fparams.num_labels // 32) * 32
    shapes = [tuple(p.shape) for p in build_pyramid(img, fparams.levels)]
    mode = fparams.fb_backward if fparams.fb_check else None
    stop = {"full": 0, "cheap": 0, "half": 1}.get(mode, len(shapes))
    split = mode == "cheap" and (fparams.subpixel or fparams.median_filter)
    passes = [(hw, 2 * frames if lvl >= stop else frames,
               2 if split and lvl == stop else 1)
              for lvl, hw in enumerate(shapes)]
    if mode == "single":
        passes.append((shapes[0], frames, 1))
    total = {"label_minor_from_major": len(passes),
             "extract_flow": sum(k4 for _, _, k4 in passes)}
    for (h, w), n, _ in passes:
        for k, c in k2_launches((n, h, w, nd), dev, DIRS_8, fparams,
                                8 * (fparams.invalid_cost + fparams.p2),
                                fparams.window_extent).items():
            total[k] = total.get(k, 0) + c
    return total


def k2_part(launches: dict) -> dict:
    """The K2 launches (both forms) of a {kernel: launches} record."""
    return {k: n for k, n in launches.items() if k in SGM_KERNELS}


@contextlib.contextmanager
def k2_forced(fuse: bool):
    """aggregate_paths with its K2 choice forced, whatever the card: a
    family launch for every direction group (fuse) or one launch per
    direction."""
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    keep = agg.family_launch_pays
    agg.family_launch_pays = lambda *args, **kwargs: fuse
    try:
        yield
    finally:
        agg.family_launch_pays = keep


def counted(fn):
    """(fn()'s result, {kernel: launches} of that call alone)."""
    from fsgm_tpu_torch.ops.kernels import _build
    _build.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.LAUNCHES)


def family_case(cost, img, dirs, p1, p2, adaptive, s_max, tag,
                label_ext=None, nl=None) -> int:
    """9(a): K2's family launches over the direction groups of dirs (the
    first writes a fresh S, the next adds into it) against
    sgm_sweep_family_plain, and their S against the per-direction
    launches' S; the largest absolute error (must be 0)."""
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    s_dtype = agg.plan_dtypes(s_max)
    groups = agg.direction_groups(dirs)
    s, want, worst = None, None, 0
    for group in groups:
        tables = torch.stack([agg.p2_effective(img, r, p1, p2, adaptive)
                              for r in group])
        s = agg.sgm_sweep_family(cost, tables, group, p1, s=s,
                                 s_dtype=s_dtype, label_ext=label_ext, nl=nl,
                                 p2_max=agg.p2_bound(p1, p2))
        part = agg.sgm_sweep_family_plain(cost, tables, group, p1, label_ext,
                                          nl)
        want = part if want is None else want.add_(part)
        del tables, part
        worst = max(worst, max_err(s, want))
        require(worst == 0, f"{tag}: family launch {group} != plain")
    del want
    with k2_forced(False):
        per_dir = agg.aggregate_paths(cost, img, dirs, p1, p2, adaptive,
                                      s_max, label_ext, nl)
    require(s.dtype == per_dir.dtype and torch.equal(s, per_dir),
            f"{tag}: family S != the per-direction launches' S")
    print(f"{tag}: {len(groups)} K2 family launches == plain and == the "
          f"{len(dirs)} per-direction launches (S {s.dtype}), max_abs_err "
          f"{worst}")
    return worst


def group_tables(img, dirs, p1, p2, adaptive) -> list:
    """[(group, its stacked P2' tables)] for the family launches."""
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    return [(g, torch.stack([agg.p2_effective(img, r, p1, p2, adaptive)
                             for r in g]))
            for g in agg.direction_groups(dirs)]


def family_sweeps(cost, groups, p1, s_dtype, label_ext=None, nl=None,
                  plain: bool = False, p2_max=None):
    """S of the family launches over prebuilt tables (or their plain
    version); p2_max the tables' bound."""
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    if plain:
        return sum(agg.sgm_sweep_family_plain(cost, t, g, p1, label_ext, nl)
                   for g, t in groups).to(s_dtype)
    s = None
    for g, t in groups:
        s = agg.sgm_sweep_family(cost, t, g, p1, s=s, s_dtype=s_dtype,
                                 label_ext=label_ext, nl=nl, p2_max=p2_max)
    return s


def check_variant_kernels(params, fparams, dev) -> dict:
    """9(a): the family launch, wta_right, K3 without the right-view pass,
    K1 with 9x7 census and the min16_probe forms against their plain
    versions; the largest absolute error per kernel (all must be 0)."""
    from fsgm_tpu_torch import DIRS_16
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.ops.kernels import (_build, cost, extract, probe,
                                            transpose)

    h, w, d = KITTI
    kw = dict(p1=params.p1, p2=params.p2, adaptive=params.adaptive_p2)
    tl, tr, _ = pair(h, w, d, SEED, dev)
    c = cost.census_cost(census_transform(tl, params.census_window),
                         census_transform(tr, params.census_window), d,
                         params.invalid_cost)
    k2 = family_case(c, tl, params.dirs, s_max=params.s_invalid,
                     tag="KITTI 1 frame", **kw)
    # #14: the down family added into an S that holds the horizontal pair
    horiz = [r for r in params.dirs if r[0] == 0]
    down = [r for r in params.dirs if r[0] == 1]
    s0 = agg.aggregate_paths(c, tl, horiz, params.p1, params.p2,
                             params.adaptive_p2, params.s_invalid)
    (_, tables), = group_tables(tl, down, **kw)
    got = agg.sgm_sweep_family(c, tables, down, params.p1, s=s0.clone(),
                               p2_max=agg.p2_bound(params.p1, params.p2))
    e = max_err(got, s0.to(torch.int32) + agg.sgm_sweep_family_plain(
        c, tables, down, params.p1))
    require(e == 0, f"down family into S != plain ({e})")
    print(f"KITTI down family {down} added into S: == plain, max_abs_err {e}")
    k2 = max(k2, e)
    s = agg.aggregate_paths(c, tl, params.dirs, params.p1, params.p2,
                            params.adaptive_p2, params.s_invalid)
    k3 = max_err(extract.wta_right(s, params.s_invalid),
                 extract.wta_right_plain(s, params.s_invalid))
    got = extract.extract_stereo(s, params.s_invalid, params.lr_max_diff,
                                 params.subpixel, with_rwta=False)
    want = extract.extract_stereo_plain(s, params.s_invalid,
                                        params.lr_max_diff, params.subpixel,
                                        with_rwta=False)
    k3_left = max(max_err(a, b) for a, b in zip(got[:4], want[:4]))
    require(k3 == 0 and k3_left == 0 and got[4] is None,
            f"KITTI wta_right {k3} / K3 without rwta {k3_left} != plain")
    g = torch.Generator(device=dev).manual_seed(SEED)
    sp = torch.randint(0, 1 << 15, PROBE_SHAPE, generator=g, device=dev,
                       dtype=torch.int32)
    k3 = max(k3, max_err(extract.wta_right(sp, 1 << 15),
                         extract.wta_right_plain(sp, 1 << 15)))
    require(k3 == 0, "wta_right at the probe shape != plain")
    print(f"wta_right == plain at KITTI ({s.dtype}) and at {PROBE_SHAPE} "
          f"int32; K3 without the right-view pass == plain: max_abs_err "
          f"{k3}, {k3_left}")
    del s, s0, sp, got, want
    c97 = (census_transform(tl, (9, 7)), census_transform(tr, (9, 7)), d,
           params.invalid_cost, False, 62)
    k1 = max_err(cost.census_cost(*c97), cost.census_cost_plain(*c97))
    require(k1 == 0, "K1 with 9x7 census != plain")
    print(f"K1 with 9x7 census (62 bits) == plain at KITTI: max_abs_err {k1}")
    # 16 frames, int16 S
    bl, br = frame_stack(h, w, d, BATCH, SEED, dev, bleed=True)
    bc = cost.census_cost(census_transform(bl, params.census_window),
                          census_transform(br, params.census_window), d,
                          params.invalid_cost)
    k2 = max(k2, family_case(bc, bl, params.dirs, s_max=params.s_invalid,
                             tag=f"KITTI {BATCH} frames", **kw))
    # K3's right-view pass and K3 without it over the 16 frames' S, held
    # frame by frame to their plain versions
    bs = agg.aggregate_paths(bc, bl, params.dirs, params.p1, params.p2,
                             params.adaptive_p2, params.s_invalid)
    del bl, br, bc
    rho = extract.wta_right(bs, params.s_invalid)
    left = extract.extract_stereo(bs, params.s_invalid, params.lr_max_diff,
                                  params.subpixel, with_rwta=False)
    require(left[4] is None, "K3 without rwta gave a validity plane")
    for k in range(BATCH):
        k3 = max(k3, max_err(rho[k], extract.wta_right_plain(
            bs[k], params.s_invalid)))
        want = extract.extract_stereo_plain(bs[k], params.s_invalid,
                                            params.lr_max_diff,
                                            params.subpixel, with_rwta=False)
        k3_left = max([k3_left] + [max_err(x[k], y)
                                   for x, y in zip(left[:4], want[:4])])
    require(k3 == 0 and k3_left == 0,
            f"{BATCH}-frame wta_right {k3} / K3 without rwta {k3_left} != "
            f"plain")
    print(f"KITTI {BATCH} frames ({bs.dtype} S): wta_right and K3 without "
          f"the right-view pass == plain frame by frame, max_abs_err {k3}, "
          f"{k3_left}")
    del bs, rho, left, want
    torch.cuda.empty_cache()
    sl, sr = frame_stack(*SMALL, 2, SEED, dev, bleed=True)
    sc = cost.census_cost(census_transform(sl), census_transform(sr),
                          SMALL[2])
    k2 = max(k2, family_case(sc, sl, DIRS_16, 7, 60, True, 40000,
                             "37x53x32 16-path adaptive, int32 S"))
    lv = flow_level(FLOW_HW, fparams, dev)
    fc = transpose.label_minor_from_major(lv.pop("cost_m"))
    k2 = max(k2, family_case(fc, lv["img"], lv["dirs"], lv["p1"], fparams.p2,
                             fparams.adaptive_p2,
                             8 * (fparams.invalid_cost + fparams.p2),
                             "config-4 level 0 (2D labels, 81 in 96)",
                             lv["e"], lv["nl"]))
    del lv, fc
    g = torch.Generator(device=dev).manual_seed(SEED)
    a, b = (torch.randint(-32768, 32768, (MIN16_N,), generator=g, device=dev,
                          dtype=torch.int32) for _ in range(2))
    a[:3] = torch.tensor([-32768, 32767, 5], device=dev)
    b[:3] = torch.tensor([32767, -32768, 5], device=dev)
    k16 = 0
    for form in probe.FORMS:
        x, y = (a, b) if form == "int32" else (a.to(torch.int16),
                                               b.to(torch.int16))
        k16 = max(k16, max_err(probe.min_probe(x, y, form),
                               torch.minimum(x, y)))
        require(k16 == 0, f"min16_probe {form} != torch.minimum")
    print(f"min16_probe {probe.FORMS} == torch.minimum on {MIN16_N} values: "
          f"max_abs_err {k16}")
    # heads and tails: counts around a 16-byte vector, views 0-7 elements
    # off a 16-byte boundary (packed: even), b at a's offset and off it
    cases = 0
    for form in probe.FORMS:
        x, y = (a, b) if form == "int32" else (a.to(torch.int16),
                                               b.to(torch.int16))
        packed = form == "packed"
        for n in ((0, 2, 8, 10, (1 << 20) + 4) if packed
                  else (0, 1, 7, 9, (1 << 20) + 3)):
            for off in range(0, 8, 2 if packed else 1):
                for off_b in {off, (off + 2) % 8}:
                    xs, ys = x[off:off + n], y[off_b:off_b + n]
                    got = probe.min_probe(xs, ys, form)
                    require(got.shape == xs.shape, "min16_probe shape")
                    if n:
                        k16 = max(k16, max_err(got, torch.minimum(xs, ys)))
                    cases += 1
        require(k16 == 0, f"min16_probe {form} head / tail != torch.minimum")
    print(f"min16_probe heads and tails ({cases} cases: n = 0 ... 2^20 + 3, "
          f"offsets 0-7, b at and off a's offset) == torch.minimum: "
          f"max_abs_err {k16}")
    # a launch goes to the caller's current stream: _build.stream_of reads
    # torch's raw stream handle (a private torch call), held here to the
    # public handle on a stream of its own
    x, y = a.to(torch.int16), b.to(torch.int16)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        require(_build.stream_of(x) == side.cuda_stream,
                "_build.stream_of is not the current stream's handle")
        got = probe.min_probe(x, y, "packed")
    side.synchronize()
    k16 = max(k16, max_err(got, torch.minimum(x, y)))
    require(k16 == 0, "min16_probe on a side stream != torch.minimum")
    print(f"min16_probe on a side stream (stream_of == its handle) == "
          f"torch.minimum: max_abs_err {k16}")
    return {"sgm_sweep_family": k2, "wta_right": k3, "extract_stereo": k3_left,
            "census_cost": k1, "min16_probe": k16}


def check_family_choice(params, tparams, fparams, f1, f2, dev,
                        card_line: str) -> dict:
    """9(b): each path with aggregate_paths' own K2 plan (launch_plan: for
    each direction group a family launch or one launch per direction) and
    with every group forced each way (k2_forced), equal bit for bit, the K2
    launches of the three calls counted and held to the plan, and
    CUDA-event ms per frame of all three: stereo at config 2 with 1 frame
    and with 16, config 1 with 16 frames, and flow at config 4.  Returns
    {cell: record}."""
    from fsgm_tpu_torch import flow_fsgm, stereo_sgm_batch
    from fsgm_tpu_torch.ops.kernels import aggregate as agg

    h, w, d = KITTI
    bl, br = frame_stack(h, w, d, BATCH, SEED, dev)
    tl, tr = frame_stack(*TSUKUBA, BATCH, SEED, dev)
    one_l, one_r = bl[:1].contiguous(), br[:1].contiguous()
    groups = len(agg.direction_groups(params.dirs))
    cells = {  # tag: (call, frames, K2 launches of the plan, calls of it)
        "stereo config 2 B=1": (
            lambda: stereo_sgm_batch(one_l, one_r, params), 1,
            k2_launches((1, h, w, d), dev, params.dirs, params), 1),
        f"stereo config 2 B={BATCH}": (
            lambda: stereo_sgm_batch(bl, br, params), BATCH,
            k2_launches((BATCH, h, w, d), dev, params.dirs, params), 1),
        f"stereo config 1 B={BATCH}": (
            lambda: stereo_sgm_batch(tl, tr, tparams), BATCH,
            k2_launches((BATCH,) + TSUKUBA, dev, tparams.dirs, tparams), 1),
        "flow config 4": (
            lambda: flow_fsgm(f1, f2, fparams), 1,
            k2_part(flow_launches(f1, fparams, dev)), None)}
    out = {}
    for tag, (fn, frames, want, calls) in cells.items():
        got, launches = counted(fn)
        k2 = k2_part(launches)
        require(k2 == want, f"{tag}: K2 launches {k2} != the plan's {want}")
        # one K2 call a level-pass, as one K5
        calls = calls or launches["label_minor_from_major"]
        rec = dict(frames=frames, launches=k2,
                   ms=median_ms(fn, reps=5) / frames)
        for fuse, name in ((True, "family"), (False, "per_direction")):
            with k2_forced(fuse):
                other, other_launches = counted(fn)
                rec[f"{name}_ms"] = median_ms(fn, reps=5) / frames
            same = (all(torch.equal(a, b) for a, b in zip(got, other))
                    if isinstance(got, tuple) else torch.equal(got, other))
            require(same, f"{tag}: the plan's S != all {name} launches")
            forced = k2_part(other_launches)
            rec[f"{name}_launches"] = forced
            require(forced == ({"sgm_sweep_family": groups * calls} if fuse
                               else {"sgm_sweep": 8 * calls}),
                    f"{tag}: forced {name} launches {forced}")
        out[tag] = rec
        print(f"{tag}: aggregate_paths' plan launches {k2} == all family "
              f"launches ({rec['family_launches']}) == all per-direction "
              f"launches ({rec['per_direction_launches']}) bit for bit; "
              f"{rec['ms']:.4f} against {rec['family_ms']:.4f} and "
              f"{rec['per_direction_ms']:.4f} ms per frame ({card_line})")
    return out


def k2_by_plan(c, groups, plan, p1, s_dtype, p2_max, label_ext=None,
               nl=None):
    """S of K2 over prebuilt tables ([(group, stacked tables)]) as plan
    ([bool] a group: one family launch, or one launch per direction)."""
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    kw = dict(s_dtype=s_dtype, label_ext=label_ext, nl=nl, p2_max=p2_max)
    s = None
    for (g, t), family in zip(groups, plan):
        if family:
            s = agg.sgm_sweep_family(c, t, g, p1, s=s, **kw)
            continue
        for i, r in enumerate(g):
            s = agg.sgm_sweep(c, t[i], r, p1, s=s, **kw)
    return s


def time_family(params, tparams, fparams, dev, card_line: str) -> dict:
    """9(c): CUDA-event ms of the new kernels beside their plain versions,
    bounds and the per-direction launches (launches counted in one call
    each); each of the 8 KITTI directions alone (ns a step); and K2 as
    aggregate_paths' plan (launch_plan), all family launches and all
    per-direction launches over 1 to 8 KITTI frames (D=128) and over 1 to
    16 config-1 frames (D=64), around the thresholds of
    family_launch_pays."""
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.ops.kernels import cost, extract, probe, transpose
    from fsgm_tpu_torch.utils.k2_bench import longest_line

    h, w, d = KITTI
    kw = dict(p1=params.p1, p2=params.p2, adaptive=params.adaptive_p2)
    s_dtype = agg.plan_dtypes(params.s_invalid)
    s_bytes = torch.tensor([], dtype=s_dtype).element_size()
    hw = h * w
    rows = {}

    def k2_pair(c, groups, p1, nl, s_dt, label_ext=None, p2_max=None):
        """The family launches and the per-direction launches over the
        same prebuilt tables."""
        n = sum(len(g) for g, _ in groups)

        def family():
            return k2_by_plan(c, groups, [True] * len(groups), p1, s_dt,
                              p2_max, label_ext, nl)

        def per_direction():
            return k2_by_plan(c, groups, [False] * len(groups), p1, s_dt,
                              p2_max, label_ext, nl)
        return family, per_direction, n

    def k2_row(c, groups, p1, nl, frames, s_dt, label_ext=None, ops=8,
               p2_max=None):
        family, per_direction, n = k2_pair(c, groups, p1, nl, s_dt,
                                           label_ext, p2_max)
        fhw = frames * c.shape[-3] * c.shape[-2]
        eb = torch.tensor([], dtype=s_dt).element_size()
        b_ms, b_by = bound(fhw * nl + n * fhw * 4 + fhw * nl * eb,
                           ops * n * fhw * nl)
        _, fam_launches = counted(family)
        _, dir_launches = counted(per_direction)
        return dict(
            frames=frames, launches=fam_launches["sgm_sweep_family"],
            ms=median_ms(family), per_direction_ms=median_ms(per_direction),
            per_direction_launches=dir_launches["sgm_sweep"],
            plain_ms=median_ms(lambda: family_sweeps(
                c, groups, p1, s_dt, label_ext, nl, plain=True), reps=1,
                warmup=0),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)

    tl, tr, _ = pair(h, w, d, SEED, dev)
    c = cost.census_cost(census_transform(tl, params.census_window),
                         census_transform(tr, params.census_window), d,
                         params.invalid_cost)
    bound_kw = dict(p2_max=agg.p2_bound(params.p1, params.p2))
    rows["family"] = k2_row(c, group_tables(tl, params.dirs, **kw),
                            params.p1, d, 1, s_dtype, **bound_kw)
    # each direction alone, fresh S, over 10 calls back to back (so that the
    # wrapper's host work overlaps the card's): ms and ns a step of the
    # direction's longest line
    directions = []
    for (g, t) in group_tables(tl, params.dirs, **kw):
        for i, r in enumerate(g):
            ms = median_ms(lambda: agg.sgm_sweep(c, t[i], r, params.p1,
                                                 s_dtype=s_dtype, **bound_kw),
                           inner=10)
            steps = longest_line(h, w, r)
            directions.append(dict(direction=list(r), ms=ms, steps=steps,
                                   ns_per_step=ms * 1e6 / steps))
    rows["directions"] = directions
    print(f"K2 each KITTI direction alone (one frame, 10 calls back to "
          f"back): {json.dumps(directions)} ({card_line})")
    # #14: the down family added into an S
    down = [r for r in params.dirs if r[0] == 1]
    (_, tables), = group_tables(tl, down, **kw)
    s_into = agg.aggregate_paths(c, tl, [r for r in params.dirs
                                         if r[0] == 0],
                                 params.p1, params.p2, params.adaptive_p2,
                                 params.s_invalid)
    b_ms, b_by = bound(hw * d + len(down) * hw * 4 + 2 * hw * d * s_bytes,
                       8 * len(down) * hw * d)
    # each call adds at most 3 * 355 to S, which stays below 2^15
    _, into_launches = counted(lambda: agg.sgm_sweep_family(
        c, tables, down, params.p1, s=s_into))
    rows["into_s"] = dict(
        directions=down, launches=into_launches["sgm_sweep_family"],
        ms=median_ms(lambda: agg.sgm_sweep_family(c, tables, down, params.p1,
                                                  s=s_into)),
        plain_ms=median_ms(lambda: agg.sgm_sweep_family_plain(
            c, tables, down, params.p1), reps=1, warmup=0),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    require(int(s_into.max()) < (1 << 15), "timed S left the int16 range")
    s = family_sweeps(c, group_tables(tl, params.dirs, **kw), params.p1,
                      s_dtype)
    b_ms, b_by = bound(hw * d * s_bytes + hw * 4, 3 * hw * d)
    rows["wta_right"] = dict(
        shape=[h, w, d], ms=median_ms(lambda: extract.wta_right(
            s, params.s_invalid)),
        plain_ms=median_ms(lambda: extract.wta_right_plain(
            s, params.s_invalid)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    args = (s, params.s_invalid, params.lr_max_diff, params.subpixel, False)
    b_ms, b_by = bound(hw * d * s_bytes + 4 * hw * 4, 6 * hw * d)
    rows["k3_left"] = dict(
        shape=[h, w, d], ms=median_ms(lambda: extract.extract_stereo(*args)),
        plain_ms=median_ms(lambda: extract.extract_stereo_plain(*args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del c, tables, s_into, s, args
    g = torch.Generator(device=dev).manual_seed(SEED)
    sp = torch.randint(0, 1 << 15, PROBE_SHAPE, generator=g, device=dev,
                       dtype=torch.int32)
    ph, pw, pd = PROBE_SHAPE
    b_ms, b_by = bound(ph * pw * pd * 4 + ph * pw * 4, 3 * ph * pw * pd)
    rows["wta_right_probe"] = dict(
        shape=list(PROBE_SHAPE),
        ms=median_ms(lambda: extract.wta_right(sp, 1 << 15)),
        with_lr_ms=median_ms(lambda: extract.extract_stereo(
            sp, 1 << 15, 1, False, True)),
        plain_ms=median_ms(lambda: extract.wta_right_plain(sp, 1 << 15)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del sp
    bl, br = frame_stack(h, w, d, BATCH, SEED, dev)
    bc = cost.census_cost(census_transform(bl, params.census_window),
                          census_transform(br, params.census_window), d,
                          params.invalid_cost)
    rows["family_batch"] = k2_row(bc, group_tables(bl, params.dirs, **kw),
                                  params.p1, d, BATCH, s_dtype, **bound_kw)

    def by_frames(cost_b, img_b, p, frame_counts):
        """{B: K2 as aggregate_paths' plan, all family and all
        per-direction launches over the first B frames}."""
        out = {}
        for b in frame_counts:
            cb = cost_b[:b].contiguous()
            groups = group_tables(img_b[:b].contiguous(), p.dirs,
                                  p1=p.p1, p2=p.p2, adaptive=p.adaptive_p2)
            plan = [fam for _, fam in agg.launch_plan(
                cb.shape, dev, p.dirs, p.p1, p.p2, p.s_invalid)]
            family, per_direction, _ = k2_pair(
                cb, groups, p.p1, cb.shape[-1], s_dtype, None,
                agg.p2_bound(p.p1, p.p2))
            out[b] = dict(plan=plan, ms=median_ms(lambda: k2_by_plan(
                cb, groups, plan, p.p1, s_dtype, agg.p2_bound(p.p1, p.p2))),
                family_ms=median_ms(family),
                per_direction_ms=median_ms(per_direction))
        return out

    warps = {nd: agg.resident_warps(dev, nd, s_dtype, False, True)
             for nd in (64, 128)}
    rows["family_batch"]["by_frames"] = by_frames(bc, bl, params,
                                                  (1, 2, 3, 4, 6, 8))
    del bc, bl, br
    torch.cuda.empty_cache()
    th, tw, td = TSUKUBA
    ts_l, ts_r = frame_stack(th, tw, td, BATCH, SEED, dev)
    ts_c = cost.census_cost(census_transform(ts_l, tparams.census_window),
                            census_transform(ts_r, tparams.census_window),
                            td, tparams.invalid_cost)
    rows["family_batch"]["by_frames_d64"] = by_frames(ts_c, ts_l, tparams,
                                                      (1, 2, 4, 8, 16))
    rows["family_batch"]["resident_warps"] = warps
    del ts_l, ts_r, ts_c
    print(f"K2 over B frames as aggregate_paths' plan (a bool a direction "
          f"group: family launch), all family and all per-direction "
          f"launches, config 2 (D=128): "
          f"{json.dumps(rows['family_batch']['by_frames'])}; config 1 "
          f"(D=64): {json.dumps(rows['family_batch']['by_frames_d64'])}; "
          f"resident warps of the per-direction kernel {warps} "
          f"({card_line})")
    lv = flow_level(FLOW_HW, fparams, dev)
    fc = transpose.label_minor_from_major(lv.pop("cost_m"))
    tables = dict(zip(lv["dirs"], lv["p2es"]))
    groups = [(gr, torch.stack([tables[r] for r in gr]))
              for gr in agg.direction_groups(lv["dirs"])]
    rows["family_2d"] = k2_row(fc, groups, lv["p1"], lv["nl"], 1,
                               lv["s_dtype"], label_ext=lv["e"], ops=11,
                               p2_max=lv["p2_max"])
    del lv, fc, tables, groups
    for name, row in rows.items():
        if name == "directions":
            continue
        extra = "".join(f", {k} {row[k]:.4f} ms" for k in
                        ("per_direction_ms", "with_lr_ms") if k in row)
        print(f"time {name}: kernel {row['ms']:.4f} ms{extra}, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']} ({card_line})")

    g = torch.Generator(device=dev).manual_seed(SEED)
    a32, b32 = (torch.randint(-32768, 32768, (MIN16_N,), generator=g,
                              device=dev, dtype=torch.int32)
                for _ in range(2))
    a16, b16 = a32.to(torch.int16), b32.to(torch.int16)
    forms = {}
    for form in probe.FORMS:
        x, y = (a32, b32) if form == "int32" else (a16, b16)
        b_ms, b_by = bound(3 * MIN16_N * x.element_size(), MIN16_N)
        fn = (lambda x=x, y=y, form=form: probe.min_probe(x, y, form))
        forms[form] = dict(ms=median_ms(fn), device_ms=device_ms(fn),
                           bound_ms=b_ms, bound_by=b_by)
    lib16 = median_ms(lambda: torch.minimum(a16, b16))
    lib32 = median_ms(lambda: torch.minimum(a32, b32))
    lib_dev = {k: device_ms(lambda x=x, y=y: torch.minimum(x, y))
               for k, (x, y) in (("int16", (a16, b16)), ("int32", (a32, b32)))}
    rows["min16"] = dict(
        n=MIN16_N, forms=forms, ms=forms["packed"]["ms"],
        device_ms=forms["packed"]["device_ms"], plain_ms=lib16,
        bound_ms=forms["packed"]["bound_ms"],
        bound_by=forms["packed"]["bound_by"], library_ms=lib16,
        library_int32_ms=lib32, library_device_ms=lib_dev)
    print(f"time min16_probe on {MIN16_N} values (event ms of one call, "
          f"device ms): {json.dumps(forms)}; torch.minimum int16 "
          f"{lib16:.4f} ms (device {ms_text(lib_dev['int16'])}), int32 "
          f"{lib32:.4f} ms (device {ms_text(lib_dev['int32'])}) "
          f"({card_line})")
    return rows


def cli_here(args) -> tuple[list[str], list[str], dict]:
    """fsgm_tpu_torch.cli main(args + --device cuda) in this process:
    (its stdout lines, its stderr lines, {kernel: launches} counted from a
    clear just before it to just after it)."""
    from io import StringIO
    from fsgm_tpu_torch.cli.main import main as cli_main
    from fsgm_tpu_torch.ops.kernels import _build
    out, err = StringIO(), StringIO()
    _build.LAUNCHES.clear()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main([*args, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    require(rc == 0, f"cli {args} exit {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue().splitlines(), err.getvalue().splitlines(), launches


def add_counts(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in {*total, *more}}


def bench_line(lines: list[str], metric: str, tag: str) -> dict:
    """The bench's one stdout record, checked."""
    require(len(lines) == 1, f"{tag}: {len(lines)} stdout lines: {lines}")
    rec = json.loads(lines[0])
    require(list(rec) == ["metric", "value", "unit", "vs_baseline"]
            and rec["metric"] == metric and rec["value"] > 0
            and rec["unit"] == "Mpixel*disp/s", f"{tag}: record {rec}")
    return rec


def check_bench(dev, card_line: str) -> dict:
    """10: every bench cell at its shape and batch; the bench path's
    launches (all six cells)."""
    from fsgm_tpu_torch import bench
    calls = 1 + bench.REPEATS
    total = {}
    for cfg, (h, w, d, batch, metric, _) in bench.CONFIGS.items():
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lines, err, n = cli_here(["bench", "--config", cfg])
        wall = time.perf_counter() - t0
        rec = bench_line(lines, metric, f"bench {cfg}")
        ctx = json.loads(next(x for x in err if x.startswith("# bench "))
                         [len("# bench "):])
        guard = [x[2:] for x in err if x.startswith("# guard")]
        require(ctx["batch"] == batch and ctx["shape"] == [h, w, d]
                and ctx["card"] == torch.cuda.get_device_name(0),
                f"bench {cfg} context {ctx}")
        p = bench.bench_params(cfg)
        if cfg in bench.FLOW_CELLS:  # B frames in one pass a call
            want = {k: v * calls for k, v in flow_launches(
                torch.zeros((h, w), dtype=torch.uint8, device=dev), p, dev,
                batch).items()}
            require(n == want, f"bench {cfg} launches {n} != {want}")
        else:
            want = {"census_cost": calls, "extract_stereo": calls,
                    **{k: v * calls for k, v in k2_launches(
                        (batch, h, w, d), dev, p.dirs, p).items()}}
            require(n == want, f"bench {cfg} launches {n} != {want}")
        total = add_counts(total, n)
        print(f"bench {cfg}: {json.dumps(rec)}; B={batch} "
              f"{ctx['ms_frame']:.4f} ms/frame, first_call_s "
              f"{ctx['first_call_s']:.3f}, peak {ctx['peak_mib']} MiB, "
              f"vs_SoL {ctx['vs_SoL']}; {'; '.join(guard)}; launches {n}; "
              f"{wall:.1f} s ({card_line})")
    return total


def check_bench_cli(card_line: str) -> dict:
    """10: `python -m fsgm_tpu_torch.cli bench --config kitti` with
    --stages and with --trace, each in its own process."""
    from fsgm_tpu_torch import bench
    from fsgm_tpu_torch.utils.profiling import TRACE_FILE
    metric = bench.CONFIGS["kitti"][4]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for flag in (["--stages"], ["--trace", tmp]):
            proc = subprocess.run(
                [sys.executable, "-m", "fsgm_tpu_torch.cli", "bench",
                 "--config", "kitti", *flag], cwd=REPO, capture_output=True,
                text=True, timeout=600)
            require(proc.returncode == 0, f"bench {flag} exit "
                    f"{proc.returncode}: {proc.stderr[-2000:]}")
            rec = bench_line(proc.stdout.splitlines(), metric,
                             f"bench kitti {flag[0]}")
            print(f"bench kitti {flag[0]} (own process): {json.dumps(rec)}")
            if flag[0] == "--stages":
                stages = [json.loads(x) for x in proc.stderr.splitlines()
                          if x.startswith('{"stage"')]
                by = {r["stage"]: r for r in stages}
                require(list(by) == [
                    "fsgm.stereo", "fsgm.census", "fsgm.cost",
                    "fsgm.aggregate", "fsgm.aggregate.group",
                    "fsgm.extract", "fsgm.tail", "fsgm.median"]
                    and all(by[k]["device_ms"] > 0 for k in (
                        "fsgm.census", "fsgm.cost", "fsgm.aggregate.group",
                        "fsgm.extract", "fsgm.median"))
                    and all(by[k]["launches"] > 0 for k in (
                        "fsgm.cost", "fsgm.aggregate.group",
                        "fsgm.extract")), f"stages {stages}")
                for r in stages:
                    print(f"stage {json.dumps(r)} ({card_line})")
                out["stages"] = stages
            else:
                trace = Path(tmp) / TRACE_FILE
                require(trace.is_file() and trace.stat().st_size > 0,
                        f"no trace at {trace}")
                print(f"bench kitti --trace: {trace.name} "
                      f"{trace.stat().st_size} bytes")
    return out


def check_video(dev) -> dict:
    """10: `cli video` over 4 KITTI-size frames at config 4 with
    --track-levels 2, .flo out, against flow_sequence and the plain chain;
    the video path's launches."""
    from fsgm_tpu_torch import flow_fsgm_reference, flow_sequence
    from fsgm_tpu_torch.io import constant_flow_sequence, read_flo, save_gray
    preset = str(REPO / "configs" / "kitti_flow.json")
    fp = load_flow_preset()
    tp = dataclasses.replace(fp, levels=2)
    frames, _ = constant_flow_sequence(*FLOW_HW, *ENTRY_MOTION,
                                       VIDEO_FRAMES, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        names = []
        for t, f in enumerate(frames):
            save_gray(tmp / f"f{t}.png", f)
            names.append(str(tmp / f"f{t}.png"))
        (tmp / "frames.txt").write_text("\n".join(names) + "\n")
        lines, _, launches = cli_here(
            ["video", str(tmp / "frames.txt"), "-o", str(tmp / "out"),
             "--format", "flo", "--preset", preset, "--track-levels", "2"])
        recs = [json.loads(x) for x in lines]
        written = [read_flo(tmp / "out" / f"f{t}.flo")
                   for t in range(VIDEO_FRAMES - 1)]
    print(f"launches in one `cli video` run ({VIDEO_FRAMES} frames): "
          f"{launches}")
    seq = torch.from_numpy(frames).to(dev)
    flows, valids = flow_sequence(seq, fp, track_params=tp)
    prev, worst = None, 0.0
    for t in range(VIDEO_FRAMES - 1):
        ref, ref_valid = flow_fsgm_reference(
            seq[t], seq[t + 1], fp if prev is None else tp, prior_flow=prev)
        prev = torch.where(ref_valid[..., None], ref, 0.0)
        valid = valids[t]
        require(torch.equal(valid, ref_valid), f"video pair {t}: valid "
                "mask != the plain chain's")
        require(bool(valid.any()), f"video pair {t}: no valid pixel")
        err = float((flows[t] - ref)[valid].abs().max())
        masked = torch.where(valid[..., None], flows[t], 0.0).cpu().numpy()
        got_err = float(np.abs(written[t] - masked).max())
        require(err <= FLOW_TOL and got_err <= FLOW_TOL,
                f"video pair {t}: |flow - plain| {err}, |.flo - "
                f"flow_sequence| {got_err}")
        require(recs[t] == {"cmd": "video", "pair": t,
                            "out": str(tmp / "out" / f"f{t}"),
                            "valid_frac": round(float(
                                valid.float().mean()), 4)},
                f"video record {recs[t]}")
        worst = max(worst, err, got_err)
    require(recs[-1]["pairs"] == VIDEO_FRAMES - 1, f"video summary {recs}")
    print(f"cli video ({VIDEO_FRAMES} frames of {FLOW_HW}, config 4, track "
          f"levels 2, .flo): == flow_sequence and the plain chain within "
          f"{worst}, valid masks equal; {recs[-1]}")
    return launches


def load_flow_preset():
    from fsgm_tpu_torch import load_preset
    return load_preset(str(REPO / "configs" / "kitti_flow.json"))["flow"]


def write_kitti_tree(root: Path, task: str) -> None:
    """A KITTI 2015 training tree of KITTI_FRAMES frames: stereo pairs
    (random-dot, D=128, ground-truth disparity) or flow pairs (constant
    motion, ground-truth flow)."""
    from fsgm_tpu_torch.io import (constant_flow_pair, random_dot_stereo,
                                   save_gray, write_disparity_png,
                                   write_flow_png)
    tr = root / "training"
    subs = (("image_2", "image_3", "disp_occ_0") if task == "stereo"
            else ("image_2", "flow_occ"))
    for sub in subs:
        (tr / sub).mkdir(parents=True)
    h, w, d = KITTI
    for i in range(KITTI_FRAMES):
        name = f"{i:06d}_10.png"
        if task == "stereo":
            il, ir, gt = random_dot_stereo(h, w, d, seed=SEED + 60 + i)
            save_gray(tr / "image_2" / name, il)
            save_gray(tr / "image_3" / name, ir)
            write_disparity_png(tr / "disp_occ_0" / name,
                                gt.astype(np.float64))
        else:
            i1, i2, fgt = constant_flow_pair(h, w, *ENTRY_MOTION,
                                             seed=SEED + 70 + i)
            save_gray(tr / "image_2" / name, i1)
            save_gray(tr / "image_2" / f"{i:06d}_11.png", i2)
            write_flow_png(tr / "flow_occ" / name, fgt,
                           np.ones((h, w), dtype=bool))


def check_kitti(dev, params) -> dict:
    """10: `cli kitti stereo` (config 2) and `cli kitti flow` (config 4)
    over a written KITTI 2015 tree, each record equal to stereo_sgm /
    flow_fsgm scored here; the kitti path's launches (both runs)."""
    from fsgm_tpu_torch import flow_fsgm, stereo_sgm
    from fsgm_tpu_torch.eval import d1_all, fl_all
    from fsgm_tpu_torch.io.datasets import (KittiFlowDataset,
                                            KittiStereoDataset)
    fp = load_flow_preset()
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        for task, preset in (("stereo", "kitti_stereo.json"),
                             ("flow", "kitti_flow.json")):
            root = Path(tmp) / task
            write_kitti_tree(root, task)
            lines, _, n = cli_here(["kitti", task, str(root), "--preset",
                                    str(REPO / "configs" / preset)])
            print(f"launches in one `cli kitti {task}` run "
                  f"({KITTI_FRAMES} frames): {n}")
            total = add_counts(total, n)
            recs = [json.loads(x) for x in lines]
            if task == "stereo":
                ds = KittiStereoDataset(root, year=2015)
                want = [d1_all(stereo_sgm(
                    torch.tensor(s.left, device=dev),
                    torch.tensor(s.right, device=dev), params).cpu().numpy(),
                    s.gt.astype(np.float64), s.gt_valid) for s in ds]
            else:
                ds = KittiFlowDataset(root, year=2015)
                want = []
                for s in ds:
                    fl, va = flow_fsgm(torch.tensor(s.img1, device=dev),
                                       torch.tensor(s.img2, device=dev), fp)
                    want.append(fl_all(fl.cpu().numpy(), s.gt, s.gt_valid,
                                       pred_valid=va.cpu().numpy()))
            got = [{k: v for k, v in r.items() if k not in ("frame",
                                                             "wall_s")}
                   for r in recs[:-1]]
            require(got == want and [r["frame"] for r in recs[:-1]]
                    == ds.ids, f"kitti {task} records {recs} != {want}")
            key, entry = (("d1_all", "stereo_sgm") if task == "stereo"
                          else ("fl_all", "flow_fsgm"))
            require(recs[-1]["frames"] == recs[-1]["scored"] == KITTI_FRAMES
                    and recs[-1][key] == round(float(np.mean(
                        [m[key] for m in want])), 4),
                    f"kitti {task} summary {recs[-1]}")
            print(f"cli kitti {task} ({KITTI_FRAMES} frames of {KITTI[:2]}):"
                  f" records == {entry} scored here; {recs[-1]}")
    return total


def rank_run(task: str, params, dist, a, b, tmp: Path, tag: str,
             devices_per_proc: int = 1) -> dict:
    """One run of a ranks job (fsgm_tpu_torch/parallel/ranks.py): the whole
    (F, H, W) batch written for the ranks to read, rank 0's result to
    tmp/<tag>_out.npz."""
    from fsgm_tpu_torch.parallel.ranks import run_spec
    return run_spec(task, params, dist, a, b, tmp / f"{tag}_in.npz",
                    tmp / f"{tag}_out.npz", devices_per_proc=devices_per_proc)


def on_ranks(runs: list, device: str, tags: list) -> list:
    """The runs on RANKS ranks of a gloo group; every rank must load no
    module of jax, fsgm_tpu or golden and return the same result; each
    rank's wall, peak and launches printed.  The reports, by rank."""
    from fsgm_tpu_torch.parallel import ranks
    job = {"device": device, "timeout_s": RANK_TIMEOUT_S, "runs": runs}
    t0 = time.perf_counter()
    reports = ranks.launch(job, RANKS)
    print(f"{RANKS} ranks ({device}): {time.perf_counter() - t0:.2f} s from "
          f"start to exit")
    for rep in reports:
        require(rep["foreign"] == [], f"rank {rep['rank']} loaded "
                f"{rep['foreign']}")
    for i, tag in enumerate(tags):
        require(len({rep["runs"][i]["digest"] for rep in reports}) == 1,
                f"{tag}: the ranks returned different results")
        for rep in reports:
            r = rep["runs"][i]
            peak = "" if r["peak_mib"] is None else \
                f", peak {r['peak_mib']:.1f} MiB"
            print(f"{tag}, rank {rep['rank']}/{rep['world']} on "
                  f"{rep['device']}: first call {r['wall_s'] * 1e3:.2f} ms"
                  f"{peak}, launches {r['launches']}")
    return reports


def rank_launches(reports: list, i: int) -> dict:
    """Run i's kernel launches, summed over the ranks."""
    total: dict = {}
    for rep in reports:
        total = add_counts(total, rep["runs"][i]["launches"])
    return total


def check_multiproc(dev, params, fparams, flow_launches: dict,
                    card_line: str) -> tuple[dict, dict]:
    """11(a)-(c): config 5 (fast as the preset gives it, and exact), 16
    frames of config 2 and 2 frames of config 4 flow, each across RANKS
    ranks sharing this card (one launch of the ranks for all four runs),
    against the single-process calls here; the multiproc paths' launches
    (summed over the ranks)."""
    from fsgm_tpu_torch import (DistParams, flow_fsgm, load_preset,
                                stereo_sgm_batch, stereo_sgm_sharded)
    preset = load_preset(CONFIG5)
    p5, d5 = preset["sgm"], preset["dist"]
    require(d5.frame_shards == RANKS, f"config 5 has {d5.frame_shards} "
            f"frame shards, not {RANKS}")
    exact5 = dataclasses.replace(d5, tile_mode="exact")
    h, w, d = UHD
    ul, ur = frame_stack(h, w, d, RANKS, SEED, dev)
    kl, kr = frame_stack(*KITTI, BATCH, SEED, dev)
    f1, f2 = (torch.stack(x) for x in zip(*[
        flow_pair(*FLOW_HW, SEED + k, dev)[:2] for k in range(RANKS)]))
    frames = DistParams(frame_shards=RANKS)
    tags = ["config 5 fast", "config 5 exact", f"config 2 x {BATCH}",
            "config 4 flow"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        runs = [rank_run("stereo", p5, d5, ul, ur, tmp, "c5f",
                         d5.tiles_y),
                rank_run("stereo", p5, exact5, ul, ur, tmp, "c5e",
                         d5.tiles_y),
                rank_run("stereo", params, frames, kl, kr, tmp, "c2"),
                rank_run("flow", fparams, frames, f1, f2, tmp, "c4")]
        reports = on_ranks(runs, "cuda", tags)
        got = [np.load(tmp / f"{t}_out.npz") for t in ("c5f", "c5e", "c2",
                                                       "c4")]
        got = [{k: z[k] for k in z.files} for z in got]

    def single(fn) -> tuple:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t0) * 1e3,
                torch.cuda.max_memory_allocated() / 2 ** 20)

    want, ms, peak = single(lambda: stereo_sgm_sharded(ul, ur, p5, d5))
    print(f"config 5 fast in one process (stereo_sgm_sharded, 8 tiles on "
          f"this card): {ms:.2f} ms, peak {peak:.1f} MiB ({card_line})")
    require(np.array_equal(got[0]["out"], want.cpu().numpy()),
            "config 5 fast across ranks != single-process "
            "stereo_sgm_sharded")
    want, ms, peak = single(lambda: stereo_sgm_batch(ul, ur, p5))
    print(f"config 5 stereo_sgm_batch in one process: {ms:.2f} ms, peak "
          f"{peak:.1f} MiB ({card_line})")
    require(np.array_equal(got[1]["out"], want.cpu().numpy()),
            "config 5 exact across ranks != stereo_sgm_batch")
    want, ms, peak = single(lambda: stereo_sgm_batch(kl, kr, params))
    print(f"config 2 stereo_sgm_batch ({BATCH} frames) in one process: "
          f"{ms:.2f} ms, peak {peak:.1f} MiB ({card_line})")
    require(np.array_equal(got[2]["out"], want.cpu().numpy()),
            f"config 2 x {BATCH} across ranks != stereo_sgm_batch")
    for k in range(RANKS):
        fl, va = flow_fsgm(f1[k], f2[k], fparams)
        require(np.array_equal(got[3]["out"][k], fl.cpu().numpy())
                and np.array_equal(got[3]["valid"][k], va.cpu().numpy()),
                f"config 4 flow across ranks, frame {k} != flow_fsgm")
    print(f"across {RANKS} ranks: config 5 fast == stereo_sgm_sharded, "
          f"exact == stereo_sgm_batch, config 2 x {BATCH} == "
          f"stereo_sgm_batch, config 4 flow == flow_fsgm (validity and "
          f"flow), bit for bit")
    stereo = rank_launches(reports, 0)
    tiles = d5.frame_shards * d5.tiles_y
    n_v = sum(1 for r in p5.dirs if r[0] != 0)
    want_s = {"census_cost": tiles, "extract_stereo": tiles,
              "sgm_sweep": tiles * (len(p5.dirs) + n_v) - RANKS * n_v}
    require(stereo == want_s, f"multiproc launches {stereo} != {want_s}")
    flow = rank_launches(reports, 3)
    want_f = {k: RANKS * n for k, n in flow_launches.items()}
    require(flow == want_f, f"multiproc flow launches {flow} != {want_f}")
    print(f"launches summed over the ranks: config 5 fast {stereo}, config "
          f"2 x {BATCH} {rank_launches(reports, 2)}, config 4 flow {flow}")
    return stereo, flow


def check_scale_test(card_line: str) -> None:
    """11(d): `cli scale-test --procs RANKS` for both tasks on this card:
    exit 0 and one JSON line each."""
    for task in ("stereo", "flow"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fsgm_tpu_torch.cli", "scale-test",
             "--task", task, "--procs", str(RANKS)], cwd=REPO,
            capture_output=True, text=True, timeout=2 * RANK_TIMEOUT_S)
        require(proc.returncode == 0, f"scale-test {task} exited "
                f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        require(len(lines) == 1, f"scale-test {task} printed {lines}")
        rep = json.loads(lines[0])
        require({"hosts", "frames_per_s", "weak_scaling_efficiency",
                 "frames_per_s_1host", "device"} <= set(rep),
                f"scale-test {task}: {rep}")
        print(f"scale-test {task} ({time.perf_counter() - t0:.2f} s): "
              f"{lines[0]} ({card_line}; {RANKS} ranks share one card: no "
              f"weak-scaling figure)")


def check_cpu_ranks() -> None:
    """11(e): tests/distributed/test_multihost.py's case on the CPU (2
    frames of 32x48, D=16, 4 row tiles a rank, exact) across RANKS ranks,
    each frame equal to the port's stereo_sgm."""
    from fsgm_tpu_torch import DistParams, SGMParams, stereo_sgm
    p = SGMParams(max_disp=16, p1=7, p2=60)
    dp = DistParams(tiles_y=4, frame_shards=RANKS, tile_mode="exact")
    cpu = torch.device("cpu")
    il, ir = frame_stack(32, 48, 16, RANKS, 0, cpu)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        on_ranks([rank_run("stereo", p, dp, il, ir, tmp, "cpu", 4)], "cpu",
                 ["32x48 on the CPU"])
        got = np.load(tmp / "cpu_out.npz")["out"]
    for k in range(RANKS):
        require(np.array_equal(got[k], stereo_sgm(il[k], ir[k], p).numpy()),
                f"CPU ranks, frame {k} != stereo_sgm")
    print(f"CPU: {RANKS} ranks x 4 row tiles (32x48, D=16, exact) == "
          f"stereo_sgm on each frame")


def check_dsharded(params, dev, card_line: str) -> dict:
    """11(f): stereo_sgm_dsharded at config 2 on one KITTI frame over
    DSHARD_TD label slices on this card, and at 37x53 with 16 paths,
    adaptive P2 over 2, each equal to stereo_sgm; the times."""
    from fsgm_tpu_torch import SGMParams, stereo_sgm
    from fsgm_tpu_torch.parallel import stereo_sgm_dsharded
    out = {}
    small = SGMParams(max_disp=SMALL[2], p1=7, p2=60, num_paths=16,
                      adaptive_p2=True)
    for shape, p, td, tag in ((KITTI, params, DSHARD_TD, "kitti"),
                              (SMALL, small, 2, "37x53 16-path adaptive")):
        tl, tr, _ = pair(*shape, SEED, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = stereo_sgm_dsharded(tl, tr, p, [dev] * td)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        require(torch.equal(got, stereo_sgm(tl, tr, p)),
                f"dsharded {tag} td={td} != stereo_sgm")
        out[tag] = dict(td=td, ms=ms)
        print(f"stereo_sgm_dsharded {tag} {shape}, td={td} == stereo_sgm; "
              f"{ms:.1f} ms (plain torch, one step a row; {card_line})")
    return out


def check_dryrun(card_line: str) -> None:
    """11(g): dryrun_multichip(n) for n = 1, 2, 3, 4, 8 on this card."""
    from fsgm_tpu_torch.parallel.dryrun import dryrun_multichip
    for n in (1, 2, 3, 4, 8):
        t0 = time.perf_counter()
        dryrun_multichip(n)
        print(f"dryrun_multichip({n}) on n x cuda:0: every exact mode == "
              f"its untiled counterpart ({time.perf_counter() - t0:.2f} s; "
              f"{card_line})")


def exact_err(a, b) -> int:
    """0 where a equals b bit for bit, else the largest |a - b|."""
    return 0 if torch.equal(a, b) else max_err(a, b)


def check_flow_frame_axis(fparams, dev, card_line: str) -> tuple:
    """12(a): K5 and K4 with a frame axis against their plain versions, one
    launch each: on FLOW_BATCH config-4 level-0 frames (the batched path's
    cost, K2 over the frames, then K4), on UHD_K5_FRAMES frames of the 4K
    level-0 label-major cost (random bytes, more than 2^31 bytes: the
    kernels' 64-bit offsets) and on UHD_K4_FRAMES frames of 4K level-0
    int16 S (random values below 2^15); the level-0 frames' K5 and K4
    timed beside their plain versions and bounds.  Returns (errs, times)."""
    from fsgm_tpu_torch.ops.kernels import extract, transpose
    lv = flow_level(FLOW_HW, fparams, dev, frames=FLOW_BATCH)
    (c, n5) = counted(lambda: transpose.label_minor_from_major(lv["cost_m"]))
    errs = {"label_minor_from_major": exact_err(
        c, transpose.label_minor_from_major_plain(lv["cost_m"]))}
    s = flow_sweeps(lv, c)
    nl, e = lv["nl"], lv["e"]
    _, n4 = counted(lambda: extract.extract_flow(s, nl, e))
    require(n5 == {"label_minor_from_major": 1}
            and n4 == {"extract_flow": 1},
            f"frame axis: K5 {n5}, K4 {n4} launches, not one each")
    errs["extract_flow"] = k4_err(s, nl, e, f"K4 over {FLOW_BATCH} frames")
    require(errs["label_minor_from_major"] == 0,
            f"K5 over {FLOW_BATCH} frames != plain")
    fh, fw = FLOW_HW
    nd = c.shape[-1]
    px = FLOW_BATCH * fh * fw
    cost_m = lv["cost_m"]
    work = {
        "label_minor_from_major": (
            lambda: transpose.label_minor_from_major(cost_m),
            lambda: transpose.label_minor_from_major_plain(cost_m),
            (2 * px * nd, 0),
            lambda: cost_m.transpose(-2, -1).contiguous()),
        "extract_flow": (
            lambda: extract.extract_flow(s, nl, e, fparams.subpixel),
            lambda: extract.extract_flow_plain(s, nl, e, fparams.subpixel),
            (px * nl * s.element_size() + 7 * px * 4, 3 * px * nl), None)}
    times = {}
    for name, (kern, plain, (nbytes, nops), lib) in work.items():
        b_ms, b_by = bound(nbytes, nops)
        t = dict(frames=FLOW_BATCH, ms=median_ms(kern),
                 device_ms=device_ms(kern),
                 plain_ms=median_ms(plain, reps=5, warmup=1), bound_ms=b_ms,
                 bound_by=b_by,
                 library_ms=None if lib is None else median_ms(lib))
        if lib is not None:
            t["library_device_ms"] = device_ms(lib)
        times[name] = t
        print(f"time {name} over {FLOW_BATCH} config-4 level-0 frames (one "
              f"launch): {json.dumps(t)} ({nbytes} B, {nops} ops; "
              f"{card_line})")
    del lv, c, s, cost_m, work
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h, w = UHD[:2]
    vol = torch.randint(0, 256, (UHD_K5_FRAMES, h, 96, w), generator=gen,
                        device=dev, dtype=torch.uint8)
    require(vol.numel() > 1 << 31, "the 4K K5 volume is below 2^31 bytes")
    err = exact_err(transpose.label_minor_from_major(vol),
                    transpose.label_minor_from_major_plain(vol))
    require(err == 0, f"K5 over {UHD_K5_FRAMES} 4K level-0 frames != plain")
    errs["label_minor_from_major"] = max(errs["label_minor_from_major"], err)
    del vol
    torch.cuda.empty_cache()
    s = torch.randint(0, 1 << 15, (UHD_K4_FRAMES, h, w, 96), generator=gen,
                      device=dev, dtype=torch.int16)
    errs["extract_flow"] = max(errs["extract_flow"], k4_err(
        s, nl, e, f"K4 over {UHD_K4_FRAMES} 4K level-0 frames"))
    del s
    torch.cuda.empty_cache()
    print(f"K5 and K4 with a frame axis == plain, one launch each: "
          f"{FLOW_BATCH} config-4 level-0 frames, {UHD_K5_FRAMES} 4K "
          f"label-major costs ({UHD_K5_FRAMES * h * 96 * w} B), "
          f"{UHD_K4_FRAMES} 4K int16 S: {errs}")
    return errs, times


def check_flow_batch(fparams, dev, fref, fref_valid, card_line: str
                     ) -> tuple:
    """12(b)-(d): flow_fsgm_batch on FLOW_BATCH config-4 frames (seeds SEED
    ...) equal to per-frame flow_fsgm bit for bit, frame 0 held to
    flow_fsgm_reference (phase 5's), its launches held to the lockstep
    plan; every fb_backward x fb_grid mode at MODES_HW over MODES_FRAMES
    frames, batched (and chunk 2) equal to per-frame, launches held to the
    plan, frame 0 held to flow_fsgm_reference; ms, device launches, busy
    share and peak a frame at B = 1 and B = FLOW_BATCH
    (utils/profiling.profile_flow).  Returns (the flow_batch path's
    launches, {B: record})."""
    from fsgm_tpu_torch import flow_fsgm, flow_fsgm_batch, flow_fsgm_reference
    from fsgm_tpu_torch.utils.profiling import profile_flow
    i1, i2 = (torch.stack(x) for x in zip(*[
        flow_pair(*FLOW_HW, SEED + k, dev)[:2] for k in range(FLOW_BATCH)]))
    (flows, valids), launches = counted(
        lambda: flow_fsgm_batch(i1, i2, fparams))
    want = flow_launches(i1[0], fparams, dev, FLOW_BATCH)
    require(launches == want, f"flow_fsgm_batch x {FLOW_BATCH} launches "
            f"{launches} != the lockstep plan's {want}")
    for k in range(FLOW_BATCH):
        f, v = flow_fsgm(i1[k], i2[k], fparams)
        require(torch.equal(flows[k], f) and torch.equal(valids[k], v),
                f"flow_fsgm_batch frame {k} != flow_fsgm")
    require(torch.equal(valids[0], fref_valid), "batched frame 0: validity "
            "!= flow_fsgm_reference")
    ferr = float((flows[0] - fref)[valids[0]].abs().max())
    require(ferr <= FLOW_TOL, f"batched frame 0: flow error {ferr}")
    print(f"flow_fsgm_batch ({FLOW_BATCH} config-4 frames, one pass) == "
          f"per-frame flow_fsgm bit for bit; frame 0 vs flow_fsgm_reference:"
          f" validity equal, max |flow err| {ferr}; launches {launches} "
          f"(one K5 and one K4 a level-pass, as at B = 1)")
    del flows, valids
    # chunk=None on the card: as many frames a pass as its free memory
    # holds, so 3 4K pairs (~27 GB a frame) do not go in one pass
    from fsgm_tpu_torch.models import flow as flow_mod
    uhd = torch.zeros((3,) + UHD[:2], dtype=torch.uint8, device=dev)
    n_uhd = flow_mod._frames_a_pass(uhd, dataclasses.replace(
        fparams, levels=UHD_FLOW_LEVELS))
    require(1 <= n_uhd < 3, f"chunk=None would run {n_uhd} 4K frames a pass")
    print(f"flow_fsgm_batch chunk=None: {FLOW_BATCH} config-4 frames in one "
          f"pass, {n_uhd} of 3 4K frames a pass "
          f"({flow_mod._free_bytes(dev) / 2**30:.1f} GiB free)")
    del uhd
    m1, m2 = (torch.stack(x) for x in zip(*[
        flow_pair(*MODES_HW, SEED + k, dev)[:2]
        for k in range(MODES_FRAMES)]))
    for fb_backward in ("full", "cheap", "single", "half"):
        for fb_grid in ("full", "half"):
            p = dataclasses.replace(fparams, fb_backward=fb_backward,
                                    fb_grid=fb_grid)
            tag = f"{fb_backward}/{fb_grid}"
            (bf, bv), n = counted(lambda: flow_fsgm_batch(m1, m2, p))
            want = flow_launches(m1[0], p, dev, MODES_FRAMES)
            require(n == want, f"{tag}: launches {n} != {want}")
            cf, cv = flow_fsgm_batch(m1, m2, p, chunk=2)
            for k in range(MODES_FRAMES):
                f, v = flow_fsgm(m1[k], m2[k], p)
                require(torch.equal(bf[k], f) and torch.equal(bv[k], v)
                        and torch.equal(cf[k], f) and torch.equal(cv[k], v),
                        f"{tag}: batched frame {k} != flow_fsgm")
            rf, rv = flow_fsgm_reference(m1[0], m2[0], p)
            require(torch.equal(bv[0], rv) and bool(rv.any()),
                    f"{tag}: validity != flow_fsgm_reference")
            err = float((bf[0] - rf)[rv].abs().max())
            require(err <= FLOW_TOL, f"{tag}: flow error {err}")
    print(f"every fb_backward x fb_grid mode at {MODES_HW}, {MODES_FRAMES} "
          f"frames: flow_fsgm_batch (chunk None and 2) == per-frame "
          f"flow_fsgm bit for bit, launches == the lockstep plan, frame 0 "
          f"== flow_fsgm_reference within {FLOW_TOL}")
    per_frame = {}
    for b in (1, FLOW_BATCH):
        a1, a2 = (i1[0], i2[0]) if b == 1 else (i1, i2)
        _, n = counted(lambda: flow_fsgm_batch(a1.reshape((-1,) + FLOW_HW),
                                               a2.reshape((-1,) + FLOW_HW),
                                               fparams))
        torch.cuda.empty_cache()
        rec = profile_flow(a1, a2, fparams, calls=5, warmup=2)
        per_frame[b] = {k: rec[k] for k in (
            "busy_ms", "wall_ms", "busy_share", "launches", "peak_mib")}
        per_frame[b]["kernel_launches"] = {k: v / b for k, v in n.items()}
        print(f"flow B={b}: {per_frame[b]['wall_ms']:.4f} ms/frame wall, "
              f"{per_frame[b]['busy_ms']:.4f} ms/frame busy (share "
              f"{per_frame[b]['busy_share']:.4f}), "
              f"{per_frame[b]['launches']:.2f} device launches/frame, peak "
              f"{per_frame[b]['peak_mib']:.1f} MiB, kernel-wrapper launches "
              f"a frame {per_frame[b]['kernel_launches']} ({card_line})")
    return launches, per_frame


def check_serve_flow(dev) -> None:
    """12(e): `cli serve --preset configs/kitti_flow.json` on the card with
    a flow_batch request over 2 config-4 pairs and a flow request, .flo
    out; each written field equal to flow_fsgm's (0 where invalid) and
    each valid share to its plane's."""
    from fsgm_tpu_torch import flow_fsgm
    from fsgm_tpu_torch.io import read_flo, save_gray
    fp = load_flow_preset()
    pairs = [flow_pair(*FLOW_HW, SEED + 20 + k, dev)[:2] for k in range(3)]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        names = []
        for k, (a, b) in enumerate(pairs):
            save_gray(tmp / f"a{k}.png", a.cpu().numpy())
            save_gray(tmp / f"b{k}.png", b.cpu().numpy())
            names.append((str(tmp / f"a{k}.png"), str(tmp / f"b{k}.png"),
                          str(tmp / f"f{k}.flo")))
        reqs = [{"task": "flow_batch", "id": "fb",
                 "pairs": [list(x) for x in names[:2]]},
                {"task": "flow", "id": "f", "first": names[2][0],
                 "second": names[2][1], "out": names[2][2]}]
        out = run_cli(["serve", "--preset", str(REPO / "configs" /
                                                 "kitti_flow.json")],
                      stdin="".join(json.dumps(r) + "\n" for r in reqs)
                      + "\n")
        require([r.get("id") for r in out[1:-1]] == ["fb", "f"]
                and all("error" not in r for r in out),
                f"serve flow responses {out}")
        fracs = out[1]["valid_frac"] + [out[2]["valid_frac"]]
        for (a, b), (_, _, o), frac in zip(pairs, names, fracs):
            fl, va = flow_fsgm(a, b, fp)
            want = torch.where(va[..., None], fl, 0.0).cpu().numpy()
            require(np.array_equal(read_flo(o), want)
                    and frac == round(float(va.float().mean()), 4),
                    f"serve {o} != flow_fsgm")
    print(f"cli serve flow_batch (2 pairs) + flow on {FLOW_HW} PNGs: .flo "
          f"== flow_fsgm, valid shares equal")


def check_flow_shards(fparams, dev) -> None:
    """13(c): config 4 on FLOW_BATCH frames as 2 frame shards of one row
    tile: each shard equal bit for bit to flow_fsgm_batch over its frames,
    the launches to 2 x flow_fsgm_batch's plan over a shard's frames."""
    from fsgm_tpu_torch import DistParams, flow_fsgm_batch, flow_fsgm_sharded
    i1, i2 = (torch.stack(x) for x in zip(*[
        flow_pair(*FLOW_HW, SEED + k, dev)[:2] for k in range(FLOW_BATCH)]))
    fl = FLOW_BATCH // 2
    (got, valid), launches = counted(lambda: flow_fsgm_sharded(
        i1, i2, fparams, DistParams(frame_shards=2)))
    want_n = {k: 2 * n for k, n in flow_launches(i1[0], fparams, dev,
                                                 fl).items()}
    require(launches == want_n, f"2 shards x 1 tile launches {launches} != "
            f"2 x flow_fsgm_batch's plan {want_n}")
    for a in range(2):
        shard = slice(a * fl, (a + 1) * fl)
        want, want_valid = flow_fsgm_batch(i1[shard], i2[shard], fparams)
        require(torch.equal(got[shard], want)
                and torch.equal(valid[shard], want_valid),
                f"config-4 shard {a} != flow_fsgm_batch")
    print(f"config 4, {FLOW_BATCH} frames on 2 shards x 1 row tile == "
          f"flow_fsgm_batch on each shard bit for bit; launches {launches}")


def check_multiproc_flow_batch(fparams, dev) -> dict:
    """13(d): RANKS x SHARD_FRAMES config-4 flow frames on RANKS ranks
    sharing this card (one shard of SHARD_FRAMES frames a rank, one row
    tile) equal bit for bit to the single-process flow_fsgm_sharded; the
    launches, summed over the ranks, held to RANKS x flow_fsgm_batch's plan
    over SHARD_FRAMES frames."""
    from fsgm_tpu_torch import DistParams, flow_fsgm_sharded
    n = RANKS * SHARD_FRAMES
    i1, i2 = (torch.stack(x) for x in zip(*[
        flow_pair(*FLOW_HW, SEED + k, dev)[:2] for k in range(n)]))
    dist = DistParams(frame_shards=RANKS)
    tag = f"config 4 flow, {SHARD_FRAMES} frames a rank"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        reports = on_ranks([rank_run("flow", fparams, dist, i1, i2, tmp,
                                     "c4b")], "cuda", [tag])
        with np.load(tmp / "c4b_out.npz") as z:
            got, got_valid = z["out"], z["valid"]
    want, want_valid = flow_fsgm_sharded(i1, i2, fparams, dist)
    require(np.array_equal(got, want.cpu().numpy())
            and np.array_equal(got_valid, want_valid.cpu().numpy()),
            f"{tag} across ranks != single-process flow_fsgm_sharded")
    launches = rank_launches(reports, 0)
    want_n = {k: RANKS * c for k, c in flow_launches(
        i1[0], fparams, dev, SHARD_FRAMES).items()}
    require(launches == want_n, f"{tag}: launches {launches} != {want_n}")
    print(f"{tag} on {RANKS} ranks == flow_fsgm_sharded in one process, bit "
          f"for bit; launches summed over the ranks {launches}")
    return launches


def time_tiled_flow_batch(dev, card_line: str) -> dict:
    """13(e): CUDA-event ms per frame and peak MiB of the 4K flow leg at 3
    row tiles over N = 1 and UHD_FLOW_FRAMES frames a pass, and the pass
    size chunk=None takes for UHD_FLOW_FRAMES frames on this card."""
    from fsgm_tpu_torch import flow_fsgm_sharded
    from fsgm_tpu_torch.models.flow import _free_bytes
    from fsgm_tpu_torch.parallel import tiled_flow
    fp, _, _, dist = uhd_flow(dev)
    i1, i2 = uhd_flow_frames(dev, UHD_FLOW_FRAMES)
    out = {}
    for n in sorted({1, UHD_FLOW_FRAMES}):
        out[n] = time_peak(lambda: flow_fsgm_sharded(
            i1[:n], i2[:n], fp, dist, chunk=n), n)
        print(f"time flow_tiled_batch (4K flow, {fp.levels} levels, 3 row "
              f"tiles, {n} frames a pass): {out[n]['ms']:.4f} ms/frame, "
              f"peak {out[n]['peak_mib']:.1f} MiB ({card_line})")
    torch.cuda.empty_cache()
    chosen = tiled_flow._frames_a_pass([dev] * dist.tiles_y,
                                       UHD_FLOW_FRAMES, *UHD[:2], fp)
    free = _free_bytes(dev) / 2 ** 30
    print(f"flow_fsgm_sharded chunk=None: {chosen} of {UHD_FLOW_FRAMES} 4K "
          f"frames a pass on 3 row tiles of this card ({free:.1f} GiB "
          f"free)")
    return dict(per_frame=out, chunk_none=chosen, free_gib=free)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from fsgm_tpu_torch import (DIRS_8, DIRS_16, FlowParams, SGMParams,
                                flow_fsgm, flow_fsgm_batch,
                                flow_fsgm_reference, load_preset, stereo_sgm,
                                stereo_sgm_batch, stereo_sgm_reference)
    from fsgm_tpu_torch.eval import d1_all, fl_all
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.cost import cost_volume_flow_major
    from fsgm_tpu_torch.ops.kernels import _build, cost, extract, transpose
    from fsgm_tpu_torch.ops.kernels import aggregate as agg

    # 0. the card
    dev = torch.device("cuda")
    card_line = card()
    kind = torch.cuda.get_device_name(0)
    print(card_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 1. build: one nvcc per source, all started together
    require(sorted(SOURCES) == sorted(_build.KERNELS),
            "a kernel is not checked")
    require(all(SOURCES[k][0] == _build.ENTRY[k][0] for k in SOURCES),
            "SOURCES names another library than _build.ENTRY")
    t0 = time.perf_counter()
    _build.build_all()
    for name in SOURCES:
        _build.load(name)
    print(f"build {', '.join(f'{lib}.cu' for lib in _build.LIBRARIES)} "
          f"({len(_build.ENTRY)} entry points): "
          f"{time.perf_counter() - t0:.2f} s")
    k2_ptxas = ptxas_record()
    lib_ptxas = lib_ptxas_record()

    # 2. stereo kernels against their plain versions
    params = load_preset("configs/kitti_stereo.json")["sgm"]
    errs = check_kernels(KITTI, params, dev, params.dirs, "kitti")
    small = SGMParams(max_disp=SMALL[2], p1=7, p2=60, adaptive_p2=True,
                      num_paths=16)
    errs = merge_errs(errs, check_kernels(SMALL, small, dev, DIRS_16,
                                          "37x53 16-path adaptive"))
    wide = SGMParams(max_disp=SMALL[2], p2=7000)  # s_invalid >= 2^15: int32 S
    errs = merge_errs(errs, check_kernels(SMALL, wide, dev, wide.dirs,
                                          "37x53 int32 S"))
    check_extract_ties(dev)

    # 3. flow kernels against their plain versions
    fparams = load_preset("configs/kitti_flow.json")["flow"]
    errs = merge_errs(errs, check_flow_kernels(FLOW_HW, fparams, dev,
                                               "config-4 level 0"))
    fsmall = FlowParams(search_radius=2, levels=3, adaptive_p2=True)
    errs = merge_errs(errs, check_flow_kernels(
        FLOW_SMALL, fsmall, dev, "37x53 radius 2 adaptive"))
    fwide = FlowParams(search_radius=2, levels=3, p2=5000)  # int32 S
    errs = merge_errs(errs, check_flow_kernels(FLOW_SMALL, fwide, dev,
                                               "37x53 radius 2 int32 S"))
    errs = merge_errs(errs, check_k5_levels(dev))

    # 4. the stereo path end to end, launches counted in this call only
    h, w, d = KITTI
    tl, tr, gt = pair(h, w, d, SEED, dev)
    _build.LAUNCHES.clear()
    disp = stereo_sgm(tl, tr, params)
    torch.cuda.synchronize()
    launches = {"stereo": dict(_build.LAUNCHES)}
    print(f"launches in one stereo_sgm call: {launches['stereo']}")
    want = {"census_cost": 1, **k2_launches((h, w, d), dev, params.dirs,
                                            params),
            "extract_stereo": 1}
    require(launches["stereo"] == want, f"stereo launches != {want}")
    ref = stereo_sgm_reference(tl, tr, params)
    require(tuple(disp.shape) == (h, w) and bool(torch.isfinite(disp).all()),
            "disparity shape / finiteness")
    require(torch.equal(disp < 0, ref < 0), "invalid mask != plain")
    both = (disp >= 0) & (ref >= 0)
    derr = float((disp[both] - ref[both]).abs().max())
    require(derr <= DISP_TOL, f"disparity error {derr} > {DISP_TOL}")
    m = d1_all(disp.cpu().numpy(), gt.astype(np.float64))
    print(f"stereo end to end vs plain: invalid mask equal, max |disp err| "
          f"{derr}; D1-all {m['d1_all']:.4f} EPE {m['epe']:.4f} "
          f"density {m['density']:.4f}")

    # 5. the flow path end to end, launches counted in this call only
    fh, fw = FLOW_HW
    f1, f2, fgt, fgt_valid = flow_pair(fh, fw, SEED, dev)
    _build.LAUNCHES.clear()
    flow, valid = flow_fsgm(f1, f2, fparams)
    torch.cuda.synchronize()
    launches["flow"] = dict(_build.LAUNCHES)
    print(f"launches in one flow_fsgm call: {launches['flow']}")
    want = flow_launches(f1, fparams, dev)
    require(launches["flow"] == want,
            f"flow launches {launches['flow']} != the lockstep plan's {want}")
    fref, fref_valid = flow_fsgm_reference(f1, f2, fparams)
    require(tuple(flow.shape) == (fh, fw, 2) and flow.dtype == torch.float32
            and bool(torch.isfinite(flow).all()), "flow shape / finiteness")
    require(torch.equal(valid, fref_valid), "validity plane != plain")
    require(bool(valid.any()), "no flow pixel passed the fb check")
    ferr = float((flow - fref)[valid].abs().max())
    require(ferr <= FLOW_TOL, f"flow error {ferr} > {FLOW_TOL}")
    fm = fl_all(flow.cpu().numpy().astype(np.float64), fgt, fgt_valid,
                pred_valid=valid.cpu().numpy())
    print(f"flow end to end vs plain: validity equal, max |flow err| {ferr} "
          f"on valid pixels; Fl-all {fm['fl_all']:.4f} EPE {fm['epe']:.4f} "
          f"valid share {float(valid.float().mean()):.4f} (density on "
          f"ground-truth-valid pixels {fm['density']:.4f})")
    g1, g2, _, _ = flow_pair(fh, fw, SEED + 1, dev)
    fb, vb = flow_fsgm_batch(torch.stack([f1, g1]), torch.stack([f2, g2]),
                             fparams)
    fo, vo = flow_fsgm(g1, g2, fparams)
    require(torch.equal(fb[0], flow) and torch.equal(vb[0], valid)
            and torch.equal(fb[1], fo) and torch.equal(vb[1], vo),
            "flow_fsgm_batch != per-frame")
    print("flow_fsgm_batch (2 frames) == per-frame flow_fsgm")

    # 6. batched stereo: kernels over B frames, the batched path (config 2,
    #    16 frames, launches counted in this call only), reagg and fill, CLI
    tparams = load_preset("configs/tsukuba.json")["sgm"]
    errs = merge_errs(errs, check_batch_kernels(TSUKUBA, BATCH, tparams, dev,
                                                "config-1"))
    errs = merge_errs(errs, check_batch_kernels(KITTI, BATCH, params, dev,
                                                "config-2"))
    launches["stereo_batch"] = check_batch_path(KITTI, BATCH, params, dev,
                                                "config 2")
    check_batch_path(TSUKUBA, BATCH, tparams, dev, "config 1")
    check_batch_path(UHD, 2, load_preset("configs/tiled_4k.json")["sgm"], dev,
                     "4K")
    check_lr_options(params, dev)
    check_cli(params, dev)

    # 7. timings, each kernel on its main path's inputs
    cl = census_transform(tl, params.census_window)
    cr = census_transform(tr, params.census_window)
    cost_args = (cl, cr, d, params.invalid_cost, False, params.census_bits)
    c = cost.census_cost(*cost_args)
    s_dtype = agg.plan_dtypes(params.s_invalid)
    p2_max = agg.p2_bound(params.p1, params.p2)
    p2es = [agg.p2_effective(tl, r, params.p1, params.p2, params.adaptive_p2)
            for r in params.dirs]

    def sweeps():
        s = None
        for r, p2e in zip(params.dirs, p2es):
            s = agg.sgm_sweep(c, p2e, r, params.p1, s=s, s_dtype=s_dtype,
                              p2_max=p2_max)
        return s

    def sweeps_plain():
        return sum(agg.sgm_sweep_plain(c, p2e, r, params.p1)
                   for r, p2e in zip(params.dirs, p2es)).to(s_dtype)

    ext_args = (sweeps(), params.s_invalid, params.lr_max_diff,
                params.subpixel)
    lv = flow_level(FLOW_HW, fparams, dev)
    fc = transpose.label_minor_from_major(lv["cost_m"])
    fs = flow_sweeps(lv, fc)
    nl, nd_f = lv["nl"], fc.shape[2]
    hw, s_bytes = h * w, torch.tensor([], dtype=s_dtype).element_size()
    fs_bytes = fs.element_size()
    fhw, n_dirs = fh * fw, len(params.dirs)
    work = {  # name: (kernel, plain, (bytes, ops), shape, library call)
        "census_cost": (
            lambda: cost.census_cost(*cost_args),
            lambda: cost.census_cost_plain(*cost_args),
            (2 * hw * 8 + hw * d, 3 * hw * d), (h, w, d), None),
        "sgm_sweep": (
            sweeps, sweeps_plain,
            (hw * d + n_dirs * hw * 4 + hw * d * s_bytes,
             8 * n_dirs * hw * d), (h, w, d), None),
        "extract_stereo": (
            lambda: extract.extract_stereo(*ext_args),
            lambda: extract.extract_stereo_plain(*ext_args),
            (hw * d * s_bytes + 5 * hw * 4, 6 * hw * d), (h, w, d), None),
        "sgm_sweep_2d": (
            lambda: flow_sweeps(lv, fc),
            lambda: flow_sweeps(lv, fc, plain=True),
            (fhw * nl + 8 * fhw * 4 + fhw * nl * fs_bytes, 11 * 8 * fhw * nl),
            (fh, fw, nd_f), None),
        "extract_flow": (
            lambda: extract.extract_flow(fs, nl, lv["e"], fparams.subpixel),
            lambda: extract.extract_flow_plain(fs, nl, lv["e"],
                                               fparams.subpixel),
            (fhw * nl * fs_bytes + 7 * fhw * 4, 3 * fhw * nl),
            (fh, fw, nd_f), None),
        "label_minor_from_major": (
            lambda: transpose.label_minor_from_major(lv["cost_m"]),
            lambda: transpose.label_minor_from_major_plain(lv["cost_m"]),
            (2 * fhw * nd_f, 0), (fh, fw, nd_f),
            lambda: lv["cost_m"].transpose(1, 2).contiguous()),
    }
    slow_plain = {"sgm_sweep", "sgm_sweep_2d"}  # Python loops: few reps
    times = {}
    for name, (kern, plain, (nbytes, nops), shape, lib) in work.items():
        reps = 3 if name in slow_plain else 10
        plain_ms = median_ms(plain, reps=reps, warmup=1)
        ms = median_ms(kern)
        lib_ms = median_ms(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, nops)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms)
        lib_txt = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        if name in ("extract_flow", "label_minor_from_major"):
            # the kernel's own time beside the call's
            times[name]["device_ms"] = device_ms(kern)
            lib_txt += f", device {ms_text(times[name]['device_ms'])}"
        if lib is not None:
            times[name]["library_device_ms"] = device_ms(lib)
            lib_txt += (f", library device "
                        f"{ms_text(times[name]['library_device_ms'])}")
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms by {b_by} ({nbytes} B, {nops} ops)"
              f"{lib_txt} (shape {shape}; {card_line})")
    e2e = median_ms(lambda: stereo_sgm(tl, tr, params))
    e2e_plain = median_ms(lambda: stereo_sgm_reference(tl, tr, params))
    print(f"time stereo_sgm end to end: {e2e:.4f} ms/frame, "
          f"{h * w * d / (e2e * 1e3):.1f} Mpixel*disp/s; plain pipeline "
          f"{e2e_plain:.4f} ms/frame ({h}x{w}x{d}; {card_line})")
    lv_args = (census_transform(f1, fparams.census_window),
               census_transform(f2, fparams.census_window))
    bu = torch.ones((fh, fw), dtype=torch.int32, device=dev)

    def flow_cost():
        return cost_volume_flow_major(*lv_args, bu, -bu,
                                      fparams.search_radius,
                                      fparams.invalid_cost, nl_pad=nd_f)

    print(f"flow cost build at level 0 (label-major, {nd_f} slots): "
          f"{device_launches(flow_cost)} device launches, "
          f"{median_ms(flow_cost):.4f} ms; census of one image: "
          f"{device_launches(lambda: census_transform(f1))} launches "
          f"({card_line})")
    fe2e = median_ms(lambda: flow_fsgm(f1, f2, fparams))
    fe2e_plain = median_ms(lambda: flow_fsgm_reference(f1, f2, fparams),
                           reps=3, warmup=1)
    print(f"time flow_fsgm end to end: {fe2e:.4f} ms/frame; plain pipeline "
          f"{fe2e_plain:.4f} ms/frame ({fh}x{fw}, config 4: "
          f"{dataclasses.asdict(fparams)}; {card_line})")

    # the batched path: K1, K2, K3 over its 16 frames, then ms and launches
    # per frame of stereo_sgm_batch at B=1 and B=16
    bl, br = frame_stack(h, w, d, BATCH, SEED, dev)
    bcl = census_transform(bl, params.census_window)
    bcr = census_transform(br, params.census_window)
    bcost_args = (bcl, bcr, d, params.invalid_cost, False,
                  params.census_bits)
    bc = cost.census_cost(*bcost_args)
    bp2es = [agg.p2_effective(bl, r, params.p1, params.p2,
                              params.adaptive_p2) for r in params.dirs]

    def bsweeps(plain: bool = False):
        if plain:
            return sum(agg.sgm_sweep_plain(bc, p2e, r, params.p1)
                       for r, p2e in zip(params.dirs, bp2es)).to(s_dtype)
        s = None
        for r, p2e in zip(params.dirs, bp2es):
            s = agg.sgm_sweep(bc, p2e, r, params.p1, s=s, s_dtype=s_dtype,
                              p2_max=p2_max)
        return s

    bext_args = (bsweeps(), params.s_invalid, params.lr_max_diff,
                 params.subpixel)
    bhw = BATCH * hw
    bwork = {
        "census_cost": (
            lambda: cost.census_cost(*bcost_args),
            lambda: cost.census_cost_plain(*bcost_args),
            (BATCH * (2 * hw * 8 + hw * d), 3 * bhw * d)),
        "sgm_sweep": (
            bsweeps, lambda: bsweeps(plain=True),
            (bhw * d + n_dirs * bhw * 4 + bhw * d * s_bytes,
             8 * n_dirs * bhw * d)),
        "extract_stereo": (
            lambda: extract.extract_stereo(*bext_args),
            lambda: extract.extract_stereo_plain(*bext_args),
            (bhw * d * s_bytes + 5 * bhw * 4, 6 * bhw * d)),
    }
    btimes = {}
    for name, (kern, plain, (nbytes, nops)) in bwork.items():
        plain_ms = median_ms(plain, reps=3, warmup=1)
        torch.cuda.empty_cache()
        ms = median_ms(kern)
        b_ms, b_by = bound(nbytes, nops)
        btimes[name] = dict(frames=BATCH, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(f"time {name} batched: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} "
              f"B, {nops} ops) ({BATCH} frames of {(h, w, d)}; "
              f"{card_line})")
    del bc, bp2es, bext_args
    torch.cuda.empty_cache()
    per_frame = {}
    for b in (1, BATCH):
        fl, fr = bl[:b].contiguous(), br[:b].contiguous()
        _build.LAUNCHES.clear()
        stereo_sgm_batch(fl, fr, params)
        torch.cuda.synchronize()
        k_launches = sum(_build.LAUNCHES.values()) / b
        dev_launches = device_launches(
            lambda: stereo_sgm_batch(fl, fr, params)) / b
        ms = median_ms(lambda: stereo_sgm_batch(fl, fr, params), reps=5) / b
        per_frame[b] = dict(ms=ms, device_launches=dev_launches,
                            kernel_launches=k_launches)
        print(f"time stereo_sgm_batch B={b}: {ms:.4f} ms/frame, "
              f"{h * w * d / (ms * 1e3):.1f} Mpixel*disp/s, "
              f"{dev_launches:.2f} device launches/frame, {k_launches:.4f} "
              f"kernel-wrapper launches/frame ({h}x{w}x{d}; {card_line})")
    print(f"batched path per frame, B=1 vs B={BATCH}: "
          f"{json.dumps(per_frame)} ({card_line})")

    del c, p2es, ext_args, lv, fc, fs, bl, br, bcl, bcr
    torch.cuda.empty_cache()

    # 8. tiled stereo and flow: K2 with carry, K3 on windows, config 5,
    #    KITTI tilings, the 4K flow leg, timings
    errs = merge_errs(errs, check_tiled_kernels(params, dev))
    launches["stereo_tiled"] = check_config5(dev)
    check_kitti_tiled(params, dev)
    launches["flow_tiled"] = check_uhd_flow(dev)
    errs = merge_errs(errs, check_uhd_flow_tile(dev))
    tiled_times = time_tiled(params, dev, card_line)

    # 9. the family launch, wta_right, K3 without the right-view pass, K1
    #    with 9x7 census, min16_probe; aggregate_paths' K2 choice against
    #    the other one end to end; timings
    t9 = time.perf_counter()
    errs = merge_errs(errs, check_variant_kernels(params, fparams, dev))
    choice = check_family_choice(params, tparams, fparams, f1, f2, dev,
                                 card_line)
    vtimes = time_family(params, tparams, fparams, dev, card_line)
    print(f"phase 9: {time.perf_counter() - t9:.2f} s")

    # 10. the bench (six cells), video and kitti entry points through the
    #     CLI, launches counted per entry point
    t10 = time.perf_counter()
    torch.cuda.empty_cache()
    launches["bench"] = check_bench(dev, card_line)
    check_bench_cli(card_line)
    launches["video"] = check_video(dev)
    launches["kitti"] = check_kitti(dev, params)
    print(f"phase 10: {time.perf_counter() - t10:.2f} s")

    # 11. across ranks: configs 5, 2 and 4 on RANKS ranks sharing this
    #     card, scale-test, the CPU case, disparity sharding, the dry run
    t11 = time.perf_counter()
    torch.cuda.empty_cache()
    launches["multiproc"], launches["multiproc_flow"] = check_multiproc(
        dev, params, fparams, launches["flow"], card_line)
    check_scale_test(card_line)
    check_cpu_ranks()
    check_dsharded(params, dev, card_line)
    check_dryrun(card_line)
    print(f"phase 11: {time.perf_counter() - t11:.2f} s")

    # 12. batched flow: K5 and K4 with a frame axis, flow_fsgm_batch over
    #     FLOW_BATCH frames and every mode, launches counted in its call
    #     only, per-frame numbers at B = 1 and B = FLOW_BATCH, serve
    t12 = time.perf_counter()
    torch.cuda.empty_cache()
    axis_errs, axis_times = check_flow_frame_axis(fparams, dev, card_line)
    errs = merge_errs(errs, axis_errs)
    launches["flow_batch"], flow_per_frame = check_flow_batch(
        fparams, dev, fref, fref_valid, card_line)
    check_serve_flow(dev)
    print(f"flow per frame, B=1 vs B={FLOW_BATCH}: "
          f"{json.dumps(flow_per_frame)} ({card_line})")
    print(f"phase 12: {time.perf_counter() - t12:.2f} s")

    # 13. the tiled flow's frame axis: the 4K leg over 2 frames in one
    #     pass (launches counted in its call only), K2 with carry over the
    #     2 frames' tile, shards of one tile, 2 frames a rank, timings
    t13 = time.perf_counter()
    torch.cuda.empty_cache()
    launches["flow_tiled_batch"] = check_uhd_flow(dev, UHD_FLOW_FRAMES)
    errs = merge_errs(errs, check_uhd_flow_tile(dev, UHD_FLOW_FRAMES))
    torch.cuda.empty_cache()
    check_flow_shards(fparams, dev)
    check_multiproc_flow_batch(fparams, dev)
    tiled_flow_times = time_tiled_flow_batch(dev, card_line)
    print(f"tiled flow per frame, N=1 vs N={UHD_FLOW_FRAMES}: "
          f"{json.dumps(tiled_flow_times)} ({card_line})")
    print(f"phase 13: {time.perf_counter() - t13:.2f} s")

    times["sgm_sweep_family"] = {k: vtimes["family"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    times["wta_right"] = {k: vtimes["wta_right"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    times["min16_probe"] = {k: vtimes["min16"][k] for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    for name, (_, _, _, paths) in SOURCES.items():
        for path in paths:
            require(launches[path].get(name, 0) > 0,
                    f"{name} not launched on the {path} path")

    rows = []
    for name, (lib, replaces, also, paths) in SOURCES.items():
        row = {"name": name, "route": "cuda",
               "source": f"fsgm_tpu_torch/csrc/{lib}.cu",
               "replaces": replaces,
               "launches": (launches[paths[0]].get(name, 0) if paths
                            else 0),
               "max_abs_err": errs[name], **times[name]}
        if also:
            row["also_replaces"] = also
        if len(paths) > 1:
            row["launches_by_path"] = {p: launches[p].get(name, 0)
                                       for p in paths}
        if name == "sgm_sweep":  # the row's times: 1D labels, stereo frame
            row["label_2d"] = times["sgm_sweep_2d"]
            row["directions"] = vtimes["directions"]
            row["ptxas"] = k2_ptxas
            row["carry"] = tiled_times["carry"]
            row["tile_horizontal"] = tiled_times["tile_horizontal"]
        if name == "census_cost":
            row["ptxas"] = lib_ptxas["cost"]
        if name == "extract_stereo":
            row["ptxas"] = lib_ptxas["extract"]
            row["window"] = tiled_times["window"]
            row["without_rwta"] = vtimes["k3_left"]
        if name in btimes:  # the same kernel over the batched path's frames
            row["batch"] = btimes[name]
        if name == "sgm_sweep_family":  # the row's times: a KITTI frame
            row.update(per_direction_ms=vtimes["family"]["per_direction_ms"],
                       per_direction_launches=vtimes["family"][
                           "per_direction_launches"],
                       batch=vtimes["family_batch"],
                       label_2d=vtimes["family_2d"],
                       into_s=vtimes["into_s"], choice=choice)
        if name == "wta_right":  # the row's times: a KITTI frame, int16 S
            row["probe_shape"] = vtimes["wta_right_probe"]
        if name == "extract_flow":  # the row's times: config-4 level 0
            row["ptxas"] = lib_ptxas["extract_flow"]
            row["batch"] = axis_times[name]
        if name == "label_minor_from_major":  # config-4 level 0, 96 slots
            row["ptxas"] = lib_ptxas["transpose"]
            row["batch"] = axis_times[name]
        if name == "min16_probe":  # the row's times: the packed form
            row.update(forms=vtimes["min16"]["forms"], n=MIN16_N,
                       library_int32_ms=vtimes["min16"]["library_int32_ms"],
                       library_device_ms=vtimes["min16"]["library_device_ms"],
                       ptxas=lib_ptxas["min16_probe"])
        rows.append(row)

    foreign = foreign_modules()
    require(not foreign, f"the run loaded {foreign}")
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
