"""K2 (csrc/sgm_sweep.cu) on the card: each launch form at the main paths'
shapes, one JSON line.

    python fsgm_tpu_torch/utils/k2_bench.py [--root DIR] [--tag NAME] \\
        [--out FILE.json] [--reps 10]

``--root`` imports ``fsgm_tpu_torch`` from DIR instead of this checkout, so
that one command can time two trees of the port on one card in turns (for
example a ``git archive`` of the parent commit beside the working tree:
parent, change, change, parent).  Every input is made on the card from a
seeded generator, so both trees see the same bytes; K2 does the same work
whatever the values, so no census or flow cost build is run.  It times
(CUDA events, median of ``--reps`` after two warm-ups):

  * ``ptxas``: registers, stack, shared memory and spills of every kernel
    in the tree's sgm_sweep.cu (``nvcc -Xptxas -v``);
  * ``kitti_directions``: each of config 2's 8 directions alone on one
    KITTI frame (375x1242, D=128, int16 S, fresh), timed over 10 calls back
    to back, with its longest line in steps and ns a step (ms over that
    line), and, for a tree whose wrappers take a P2' bound, the same launch
    without one (int32 labels);
  * ``by_frames``: the family launches (one per direction group) against the
    per-direction launches over B frames, config 2 (D=128; B = 1, 2, 3, 4,
    6, 8, 16) and config 1 (288x384, D=64; B = 1, 2, 4, 8, 16), in all and
    for each direction group alone, and which one the tree's
    aggregate_paths takes there;
  * ``into_s``: the family launch of the down directions added into an S
    (tools/trexp.py's kernel) on one KITTI frame;
  * ``flow_2d``: both forms on a config-4 level 0 (375x1242, 81 labels in
    96 slots, 2D rule, int16 S);
  * ``tile_carry`` and ``tile_horizontal``: the six vertical directions with
    carry in and out on a config-5 tile (2 frames of 540x3840, D=128) and
    its two horizontal directions on one frame.

Each record carries the card's name and power limit.  Only the card runs
this: it exits when torch finds no CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

if __name__ == "__main__":
    # Run as a script, this file's directory leads sys.path, and its
    # logging.py would stand in for the standard library's when torch
    # imports logging: take the directory out before anything imports torch.
    _here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _here]

DIRS_8 = [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1),
          (-1, -1)]
KITTI = (375, 1242, 128)
TSUKUBA = (288, 384, 64)
P1, P2 = 7, 100            # configs/kitti_stereo.json (and flow's P1, P2)
S_INVALID = 8 * (255 + P2) + 1
TILE = (2, 540, 3840, 128)  # configs/tiled_4k.json: tile 1 of 4, 2 frames
FLOW_L0 = (375, 1242, 96, 81, 9)  # config 4 level 0: H, W, D, labels, e


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def parse_ptxas(text: str) -> list[dict]:
    """One record per kernel of ``nvcc -Xptxas -v`` output: name, registers,
    stack frame, shared memory and spill bytes."""
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.append(dict(kernel=name, stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3))))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and out and out[-1]["kernel"] == name and "registers" not in \
                out[-1]:
            out[-1].update(registers=int(m.group(1)),
                           smem=int(m.group(2) or 0))
            name = None
    return out


def ptxas(src: Path, nvcc: str, flags) -> list[dict]:
    """parse_ptxas of one compile of src with ``-Xptxas -v``."""
    flags = [f for f in flags if f != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([nvcc, *flags, "-c", "-Xptxas", "-v", "-o",
                               str(Path(tmp) / "k.o"), str(src)],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return parse_ptxas(proc.stderr)


def longest_line(h: int, w: int, r) -> int:
    """Steps of the longest path line of direction r in an H x W frame."""
    dy, dx = (abs(v) for v in r)
    return min(-(-h // dy) if dy else w, -(-w // dx) if dx else h)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    # this checkout's root, or DIR: where fsgm_tpu_torch is imported from
    root = Path(args.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k2_bench: no CUDA device available", file=sys.stderr)
        return 1
    from fsgm_tpu_torch.ops.kernels import _build
    from fsgm_tpu_torch.ops.kernels import aggregate as agg

    dev = torch.device("cuda")
    card = card_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    # a bound on every P2' table below, for a tree whose wrappers take one
    bound_kw = ({"p2_max": max(P2, P1 + 1)} if "p2_max" in
                inspect.signature(agg.sgm_sweep).parameters else {})

    def rand(shape, hi, dtype=torch.uint8):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(dtype)

    def median_ms(fn, reps=args.reps, inner=1):
        """Median over reps of the ms of one fn() call, timed over ``inner``
        calls back to back (so that with inner > 1 the wrapper's host work
        overlaps the card's)."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / inner)
        return float(np.median(times))

    def tables(img, dirs, adaptive=True):
        return [agg.p2_effective(img, r, P1, P2, adaptive) for r in dirs]

    def per_direction(c, img, dirs, p2es, s_dtype, **kw):
        s = None
        for r, p2e in zip(dirs, p2es):
            s = agg.sgm_sweep(c, p2e, r, P1, s=s, s_dtype=s_dtype, **kw,
                              **bound_kw)
        return s

    def family(c, groups, s_dtype, **kw):
        s = None
        for g, t in groups:
            s = agg.sgm_sweep_family(c, t, g, P1, s=s, s_dtype=s_dtype, **kw,
                                     **bound_kw)
        return s

    def both(c, img, dirs, s_dtype, **kw):
        p2es = tables(img, dirs)
        by_r = dict(zip(dirs, p2es))
        groups = [(g, torch.stack([by_r[r] for r in g]))
                  for g in agg.direction_groups(dirs)]
        b = c.shape[0] if c.dim() == 4 else 1
        h, w = c.shape[-3:-1]
        if hasattr(agg, "launch_plan"):  # per direction group
            chooses = [fam for _, fam in agg.launch_plan(
                c.shape, dev, dirs, P1, P2, S_INVALID, kw.get("label_ext"))]
        else:
            chooses = agg.family_launch_pays(b, h, w, dirs,
                                             agg.resident_warps(dev))
        rec = dict(frames=b,
                   family_ms=median_ms(lambda: family(c, groups, s_dtype,
                                                      **kw)),
                   per_direction_ms=median_ms(lambda: per_direction(
                       c, img, dirs, p2es, s_dtype, **kw)),
                   family_chosen=chooses, groups=[])
        for g, t in groups:  # each group alone, both ways, fresh S
            rec["groups"].append(dict(
                directions=[list(r) for r in g],
                family_ms=median_ms(lambda: family(c, [(g, t)], s_dtype,
                                                   **kw)),
                per_direction_ms=median_ms(lambda: per_direction(
                    c, img, g, list(t), s_dtype, **kw))))
        return rec

    rec = dict(tag=args.tag, card=card, torch=torch.__version__,
               root=str(root))
    src = Path(agg.__file__).resolve().parents[2] / "csrc" / "sgm_sweep.cu"
    rec["ptxas"] = (parse_ptxas(_build.ptxas_log("sgm_sweep"))
                    if hasattr(_build, "ptxas_log")
                    else ptxas(src, _build.find_nvcc(), _build.NVCC_FLAGS))
    _build.load("sgm_sweep")
    s16 = agg.plan_dtypes(S_INVALID)
    if "nd" in inspect.signature(agg.resident_warps).parameters:
        rec["resident_warps"] = {
            f"d{nd} {mode} packed {int(packed)}": agg.resident_warps(
                dev, nd, s16, False, packed, mode)
            for nd in (64, 128) for mode in ("accum", "atomic")
            for packed in (True, False)}

    h, w, d = KITTI
    kitti_c = rand((16, h, w, d), 64)
    kitti_img = rand((16, h, w), 256)
    c1, img1 = kitti_c[:1].contiguous(), kitti_img[:1].contiguous()
    rows = []
    for r, p2e in zip(DIRS_8, tables(img1, DIRS_8)):
        ms = median_ms(lambda: agg.sgm_sweep(c1, p2e, r, P1, s_dtype=s16,
                                             **bound_kw), inner=10)
        steps = longest_line(h, w, r)
        rows.append(dict(direction=list(r), ms=ms, steps=steps,
                         lines=agg.lines_per_frame(h, w, r),
                         ns_per_step=ms * 1e6 / steps))
        if bound_kw:  # the same launch without a bound: int32 labels
            rows[-1]["int32_labels_ms"] = median_ms(lambda: agg.sgm_sweep(
                c1, p2e, r, P1, s_dtype=s16), inner=10)
    rec["kitti_directions"] = rows
    # #14: the down family (dy = 1) added into an S; 12 calls add at most
    # 12 x 3 x 355 to the zeros, which stays below 2^15
    down = [r for r in DIRS_8 if r[0] == 1]
    s_into = torch.zeros(c1.shape, dtype=s16, device=dev)
    t_down = torch.stack(tables(img1, down))
    rec["into_s"] = dict(directions=[list(r) for r in down],
                         ms=median_ms(lambda: agg.sgm_sweep_family(
                             c1, t_down, down, P1, s=s_into, **bound_kw)))
    del s_into, t_down
    by_frames = {"config2_d128": [], "config1_d64": []}
    for b in (1, 2, 3, 4, 6, 8, 16):
        c, img = kitti_c[:b].contiguous(), kitti_img[:b].contiguous()
        by_frames["config2_d128"].append(both(c, img, DIRS_8, s16))
        del c, img
    del kitti_c, kitti_img, c1, img1
    th, tw, td = TSUKUBA
    ts_c, ts_img = rand((16, th, tw, td), 64), rand((16, th, tw), 256)
    for b in (1, 2, 4, 8, 16):
        by_frames["config1_d64"].append(both(ts_c[:b].contiguous(),
                                             ts_img[:b].contiguous(),
                                             DIRS_8, s16))
    rec["by_frames"] = by_frames
    del ts_c, ts_img

    fh, fw, fd, nl, e = FLOW_L0
    fc = rand((fh, fw, fd), 64)
    fc[..., nl:] = 0
    rec["flow_2d"] = both(fc, rand((fh, fw), 256), DIRS_8,
                          agg.plan_dtypes(8 * (255 + P2)), label_ext=e,
                          nl=nl)
    del fc
    torch.cuda.empty_cache()

    b, th, tw, td = TILE
    tc, timg = rand(TILE, 64), rand((b, th, tw), 256)
    vert = [r for r in DIRS_8 if r[0] != 0]
    p2v = tables(timg, vert)
    carries = [rand((b, 2, tw, td), 300, torch.int32) for _ in vert]

    def carried():
        s = None
        for r, p2e, cin in zip(vert, p2v, carries):
            s, _ = agg.sgm_sweep(tc, p2e, r, P1, s=s, s_dtype=s16,
                                 init_carry=cin, return_carry=True,
                                 **bound_kw)
        return s

    horiz = [r for r in DIRS_8 if r[0] == 0]
    tc1, timg1 = tc[:1].contiguous(), timg[:1].contiguous()
    p2h = tables(timg1, horiz)
    rec["tile_carry"] = dict(shape=list(TILE), launches=len(vert),
                             ms=median_ms(carried, reps=5))
    rec["tile_horizontal"] = dict(
        shape=[1] + list(TILE[1:]), launches=len(horiz),
        ms=median_ms(lambda: per_direction(tc1, timg1, horiz, p2h, s16),
                     reps=5))
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
