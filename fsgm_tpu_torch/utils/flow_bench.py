"""Config-4 flow on the card at B = 1 and B = 8 frames a call, and the bench's
flow cells, one JSON line.

    python fsgm_tpu_torch/utils/flow_bench.py [--root DIR] [--tag NAME] \\
        [--out FILE.json] [--calls 5]

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
    and peak MiB.

Only the card runs this: it exits when torch finds no CUDA device.

It exists for trees of the port whose ``utils/profiling.py`` refuses
``--pipeline flow --batch B`` (those before flow's batched launch sets):
it calls their ``profile_frames`` and ``bench.run_config`` by hand.  Two
trees that both take flow ``--batch`` are compared by running
``python -m fsgm_tpu_torch.utils.profiling --pipeline flow --batch 8`` and
``python -m fsgm_tpu_torch.bench --config flow`` in each tree's checkout;
this script goes once no tree to be timed predates them.
"""

from __future__ import annotations

import argparse
import contextlib
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)
    root = Path(args.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("flow_bench: no CUDA device available", file=sys.stderr)
        return 1
    from fsgm_tpu_torch import flow_fsgm, flow_fsgm_batch, load_preset
    from fsgm_tpu_torch import bench
    from fsgm_tpu_torch.io import blockwise_flow_pair
    from fsgm_tpu_torch.ops.kernels import _build
    from fsgm_tpu_torch.utils.k2_bench import card_line
    from fsgm_tpu_torch.utils.profiling import profile_frames

    dev = torch.device("cuda")
    params = load_preset(str(root / "configs" / "kitti_flow.json"))["flow"]
    rec = dict(tag=args.tag, card=card_line(), torch=torch.__version__,
               root=str(root), per_frame={}, cells={})
    pairs = [blockwise_flow_pair(*HW, MAX_MAG, seed=k)[:2]
             for k in range(max(BATCHES))]
    for b in BATCHES:
        a1, a2 = (torch.from_numpy(np.stack([p[i] for p in pairs[:b]]))
                  .to(dev) for i in (0, 1))
        if b == 1:
            call = lambda: flow_fsgm(a1[0], a2[0], params)  # noqa: E731
        else:
            call = lambda: flow_fsgm_batch(a1, a2, params)  # noqa: E731
        call()
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        call()
        torch.cuda.synchronize()
        kernels = dict(_build.LAUNCHES)
        torch.cuda.empty_cache()
        prof = profile_frames(call, dev, args.calls, 2, b)
        rec["per_frame"][b] = dict(
            {k: prof[k] for k in ("busy_ms", "wall_ms", "busy_share",
                                  "launches", "peak_mib")},
            kernel_launches_a_call=kernels)
        print(f"# {args.tag} B={b}: {json.dumps(rec['per_frame'][b])}",
              file=sys.stderr)
    for cfg in CELLS:
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
