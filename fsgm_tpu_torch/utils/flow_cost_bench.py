"""The flow paths' cost stage on the card at config 4's shapes, one JSON
line: K6 flow_cost where the tree has it, else the label-major build
(ops/cost.py) and K5 as the tree's flow paths ran them.

    python fsgm_tpu_torch/utils/flow_cost_bench.py [--root DIR] \\
        [--tag NAME] [--out FILE.json] [--reps 10]

``--root`` imports ``fsgm_tpu_torch`` from DIR instead of this checkout, so
that one command can time two trees of the port on one card in turns (for
example a ``git archive`` of the parent commit beside the working tree:
parent, change, change, parent).  Inputs are made on the card from seeds:
random 24-bit census words (config 4's 5x5 window) and bases that are
constant over 32 x 32 blocks in [-8, 8] plus noise in [-2, 2] a pixel (a
prior flow's shape), so both trees see the same words.  Each row holds:

  * ``form``: ``flow_cost`` or ``major+k5``;
  * ``equal_plain``: the stage equals label_minor_from_major_plain of
    cost_volume_flow_major, bit for bit;
  * ``ms``: the median over ``--reps`` of one call's CUDA-event ms after
    two warm-ups;
  * ``device_ms`` / ``launches``: torch.profiler's device time of one call
    summed over every activity it launches, and the activities a call;
  * ``bound_ms``: each slice-pixel's nl_pad label bytes written and 24
    bytes read (census word, gathered word, two bases) over 3.35 TB/s.

Rows: config 4's level 0 over 1 and 8 slices (``flow_kitti.batch8``'s
forward pass), levels 1-3 over 16 (both directions of 8 frames), and the
4K flow leg's level-0 row tile 1 (720 of 2160 rows, tiled mode: bases
with 4 halo rows, y_offset 720) over 1 slice.

Only the card runs this: it exits when torch finds no CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    # Run as a script, this file's directory leads sys.path, and its
    # logging.py would stand in for the standard library's when torch
    # imports logging: take the directory out before anything imports torch.
    _here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _here]

RADIUS, NL_PAD, INVALID, BITS = 4, 96, 255, 24  # config 4
# (name, slices, H, W, second-image rows, first global row)
SHAPES = (("level0_x1", 1, 375, 1242, 375, 0),
          ("level0_x8", 8, 375, 1242, 375, 0),
          ("level1_x16", 16, 187, 621, 187, 0),
          ("level2_x16", 16, 93, 310, 93, 0),
          ("level3_x16", 16, 46, 155, 46, 0),
          ("uhd_tile", 1, 720, 3840, 2160, 720))
HBM_BYTES_PER_S = 3.35e12


def card_timing():
    """utils/card_timing.py of this bench's own tree, whichever tree --root
    names, so that both trees are timed by the same code."""
    spec = importlib.util.spec_from_file_location(
        "_fsgm_card_timing", Path(__file__).with_name("card_timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(n, h, w, h2, y0, dev, seed):
    """(cen1 (n, h, w), cen2 (n, h2, w), base_u, base_v (n, h + 2 halo,
    w)): the tile's census rows y0 ... y0 + h - 1 of an h2-row frame and
    its bases with RADIUS halo rows where it is a row tile."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    halo = RADIUS if h2 != h else 0
    cen2 = torch.randint(0, 1 << BITS, (n, h2, w), generator=gen,
                         device=dev, dtype=torch.int64)
    cen1 = torch.randint(0, 1 << BITS, (n, h2, w), generator=gen,
                         device=dev, dtype=torch.int64)[:, y0:y0 + h]
    bases = []
    for _ in "uv":
        block = torch.randint(-8, 9, (n, -(-h2 // 32), -(-w // 32)),
                              generator=gen, device=dev, dtype=torch.int32)
        field = block.repeat_interleave(32, 1).repeat_interleave(32, 2)
        field = field[:, :h2, :w] + torch.randint(
            -2, 3, (n, h2, w), generator=gen, device=dev, dtype=torch.int32)
        bases.append(field[:, y0 - halo:y0 + h + halo].contiguous())
    return (cen1.contiguous(), cen2) + tuple(bases)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    timing = card_timing()
    root = Path(args.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("flow_cost_bench: no CUDA device available", file=sys.stderr)
        return 1
    from fsgm_tpu_torch.ops.cost import cost_volume_flow_major
    from fsgm_tpu_torch.ops.kernels import transpose
    from fsgm_tpu_torch.utils.k2_bench import card_line
    try:
        from fsgm_tpu_torch.ops.kernels import flow_cost as fc
    except ImportError:
        fc = None

    def stage(a, y0):
        if fc is not None:
            return fc.flow_cost(*a, RADIUS, INVALID, NL_PAD, y_offset=y0,
                                census_bits=BITS)
        return transpose.label_minor_from_major(cost_volume_flow_major(
            *a, RADIUS, INVALID, nl_pad=NL_PAD, y_offset=y0))

    dev = torch.device("cuda")
    rec = dict(tag=args.tag, card=card_line(), torch=torch.__version__,
               root=str(root), form="flow_cost" if fc else "major+k5")
    rows = {}
    for k, (name, n, h, w, h2, y0) in enumerate(SHAPES):
        a = inputs(n, h, w, h2, y0, dev, seed=k)
        want = transpose.label_minor_from_major_plain(cost_volume_flow_major(
            *a, RADIUS, INVALID, nl_pad=NL_PAD, y_offset=y0))
        ok = torch.equal(stage(a, y0), want)
        del want
        run = lambda: stage(a, y0)  # noqa: E731
        dev_ms, launches = timing.device_total(run, args.reps)
        px = n * h * w
        rows[name] = dict(
            shape=[n, h, w], equal_plain=ok,
            ms=timing.median_ms(run, args.reps), device_ms=dev_ms,
            launches=launches,
            bound_ms=px * (NL_PAD + 24) / HBM_BYTES_PER_S * 1e3)
        del a
        torch.cuda.empty_cache()
    rec["rows"] = rows
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if all(r["equal_plain"] for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
