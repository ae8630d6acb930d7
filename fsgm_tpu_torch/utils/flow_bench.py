"""Config-4 flow on the card at B = 1 and B = 8 frames a call, the bench's
flow cells and the tiled flow's cells, one JSON line.

    python fsgm_tpu_torch/utils/flow_bench.py [--root DIR] [--tag NAME] \\
        [--out FILE.json] [--calls 5] [--parts per_frame,cells,tiled]

``--root`` imports ``fsgm_tpu_torch`` from DIR instead of this checkout, so
that one command can time two trees of the port on one card in turns (for
example a ``git archive`` of the parent commit beside the working tree:
parent, change, change, parent).  Inputs are made from seeds, so both trees
see the same frames.  The record holds:

  * ``per_frame``: for B = 1 (``flow_fsgm``) and B = 8
    (``flow_fsgm_batch``) on blockwise_flow_pair(375, 1242, 8, seed=k), k
    = 0 ... B-1, at configs/kitti_flow.json, the tree's
    ``utils/profiling.profile_frames`` over ``--calls`` calls after two
    warm-ups: device busy ms, CUDA-event wall ms, busy share and device
    launches a frame, the peak allocation of one call, and the
    kernel-wrapper launches of one call (``_build.LAUNCHES``);
  * ``cells``: the tree's ``bench.run_config`` for the ``flow`` (B = 8)
    and ``4kflow`` (B = 1) cells: ms/frame, the 6 calls' ms, first call s
    and peak MiB;
  * ``tiled``: the tree's ``flow_fsgm_sharded`` through ``profile_frames``
    as ``per_frame``: the 4K flow leg (config 4 with 5 levels and fb_grid
    "full" on blockwise_flow_pair(2160, 3840, 8, seed=k), 3 row tiles,
    exact) over N = 1 and 2 frames a call (``chunk=N`` where the tree
    takes it), and config 4 on 8 frames as 2 frame shards of one row
    tile.

``--parts`` picks the sections to run (all by default).

Only the card runs this: it exits when torch finds no CUDA device.

It calls each tree's ``profile_frames``, ``bench.run_config`` and entry
points by hand, so that trees from before flow's batched launch sets
(whose ``utils/profiling.py`` refuses ``--pipeline flow --batch B``) and
before the tiled flow's frame pass (whose ``flow_fsgm_sharded`` takes no
``chunk``) are timed by the same code.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import io
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    # Run as a script, this file's directory leads sys.path, and its
    # logging.py would stand in for the standard library's when torch
    # imports logging: take the directory out before anything imports torch.
    _here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _here]

import numpy as np

HW = (375, 1242)
BATCHES = (1, 8)
MAX_MAG = 8
CELLS = ("flow", "4kflow")
PARTS = ("per_frame", "cells", "tiled")
UHD_HW = (2160, 3840)
UHD_LEVELS = 5          # bench.py's 4kflow leg: config 4 with one more level
UHD_FRAMES = (1, 2)     # frames a call of the 4K leg at 3 row tiles
SHARD_FRAMES = 8        # config-4 frames on 2 shards of one row tile
PROFILE_ATTEMPTS = 3    # torch.profiler now and then records no launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--parts", default=",".join(PARTS))
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts takes {','.join(PARTS)}")
    root = Path(args.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("flow_bench: no CUDA device available", file=sys.stderr)
        return 1
    from fsgm_tpu_torch import (DistParams, flow_fsgm, flow_fsgm_batch,
                                flow_fsgm_sharded, load_preset)
    from fsgm_tpu_torch import bench
    from fsgm_tpu_torch.io import blockwise_flow_pair
    from fsgm_tpu_torch.ops.kernels import _build
    from fsgm_tpu_torch.utils.k2_bench import card_line
    from fsgm_tpu_torch.utils.profiling import profile_frames

    dev = torch.device("cuda")
    params = load_preset(str(root / "configs" / "kitti_flow.json"))["flow"]
    rec = dict(tag=args.tag, card=card_line(), torch=torch.__version__,
               root=str(root), per_frame={}, cells={}, tiled={})

    def profiled(call, frames: int) -> dict:
        """profile_frames' per-frame numbers of call() and the wrapper
        launches of one call."""
        call()
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        call()
        torch.cuda.synchronize()
        kernels = dict(_build.LAUNCHES)
        torch.cuda.empty_cache()
        for attempt in range(PROFILE_ATTEMPTS):
            try:
                prof = profile_frames(call, dev, args.calls, 2, frames)
                break
            except RuntimeError:
                if attempt == PROFILE_ATTEMPTS - 1:
                    raise
        return dict({k: prof[k] for k in ("busy_ms", "wall_ms", "busy_share",
                                          "launches", "peak_mib")},
                    kernel_launches_a_call=kernels)

    def stack(hw, frames):
        got = [blockwise_flow_pair(*hw, MAX_MAG, seed=k)[:2]
               for k in range(frames)]
        return (torch.from_numpy(np.stack([p[i] for p in got])).to(dev)
                for i in (0, 1))

    if "per_frame" in parts:
        b1, b2 = stack(HW, max(BATCHES))
        for b in BATCHES:
            a1, a2 = b1[:b], b2[:b]
            if b == 1:
                call = lambda: flow_fsgm(a1[0], a2[0], params)  # noqa: E731
            else:
                call = lambda: flow_fsgm_batch(a1, a2, params)  # noqa: E731
            rec["per_frame"][b] = profiled(call, b)
            print(f"# {args.tag} B={b}: {json.dumps(rec['per_frame'][b])}",
                  file=sys.stderr)
        del b1, b2
    if "tiled" in parts:
        uhd = dataclasses.replace(params, levels=UHD_LEVELS, fb_grid="full")
        u1, u2 = stack(UHD_HW, max(UHD_FRAMES))
        takes_chunk = "chunk" in inspect.signature(
            flow_fsgm_sharded).parameters
        for n in UHD_FRAMES:
            a1, a2 = u1[:n], u2[:n]
            # all N frames in one pass where the tree takes chunk (its
            # chunk=None reckons one 4K frame a pass on an 80 GB card)
            kw = dict(chunk=n) if takes_chunk else {}
            rec["tiled"][f"4k_ty3_n{n}"] = profiled(
                lambda: flow_fsgm_sharded(a1, a2, uhd, DistParams(tiles_y=3),
                                          **kw), n)
        del u1, u2, a1, a2
        s1, s2 = stack(HW, SHARD_FRAMES)
        rec["tiled"][f"config4_fs2_ty1_n{SHARD_FRAMES}"] = profiled(
            lambda: flow_fsgm_sharded(s1, s2, params,
                                      DistParams(frame_shards=2)),
            SHARD_FRAMES)
        del s1, s2
        for k, v in rec["tiled"].items():
            print(f"# {args.tag} {k}: {json.dumps(v)}", file=sys.stderr)
    for cfg in CELLS if "cells" in parts else ():
        torch.cuda.empty_cache()
        with contextlib.redirect_stdout(io.StringIO()):
            ctx = bench.run_config(cfg, device="cuda")
        rec["cells"][cfg] = {k: ctx[k] for k in (
            "batch", "shape", "ms_frame", "ms_calls", "first_call_s",
            "peak_mib")}
        print(f"# {args.tag} {cfg}: {json.dumps(rec['cells'][cfg])}",
              file=sys.stderr)
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
