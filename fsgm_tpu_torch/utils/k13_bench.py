"""K1 (csrc/cost.cu) and K3 (csrc/extract.cu) on the card at the main
paths' shapes, one JSON line.

    python fsgm_tpu_torch/utils/k13_bench.py [--root DIR] [--tag NAME] \\
        [--out FILE.json] [--reps 20]

``--root`` imports ``fsgm_tpu_torch`` from DIR instead of this checkout, so
that one command can time two trees of the port on one card in turns (for
example a ``git archive`` of the parent commit beside the working tree:
parent, change, change, parent).  Every input is made on the card from a
seeded generator, so both trees see the same bytes; neither kernel's work
depends on the values beyond the masks, so no census or K2 is run.  It
reports for each row ``ms``, the median over ``--reps`` of one call timed by
CUDA events after two warm-ups (the wrapper's host work included where it
outlasts the kernel, as in chip_smoke.py's phase 7), ``device_ms``, the
kernel's own device time per call from torch.profiler over ``--reps``
calls, and ``bound_ms``, the bytes read and written once over 3.35 TB/s:

  * ``ptxas``: registers, stack, shared memory and spills of every kernel
    in the tree's cost.cu and extract.cu (``nvcc -Xptxas -v``);
  * ``k1``: one KITTI frame (375x1242, D=128, 5x5 census: 24-bit words,
    passed as census_bits to a tree whose wrapper takes it), 16 frames, the
    right reference (lr_mode="reagg"), and 9x7 census (62-bit words); with
    each its popcount floor ``popc_floor_ms``: the tree's 32-bit POPC per
    byte (two for a tree without census_bits) over 16 a clock per SM at the
    card's largest SM clock;
  * ``k3``: int16 S of one KITTI frame and of 16 frames, each with the
    right-view pass and LR plane (with_rwta) and without (the reagg right
    view), one KITTI column window (375x983, gx0 = -181, w_global = 1242,
    config 2 at tiles_x = 2) and config 5's tile (2 frames of 540x3840,
    D=128); and wta_right on one KITTI frame.

Only the card runs this: it exits when torch finds no CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

KITTI = (375, 1242, 128)
FRAMES = 16
BITS_5X5, BITS_9X7 = 24, 62
POPC_PER_CLOCK = 16  # 32-bit POPC a clock per SM, compute capability 9.0
WINDOW = (375, 983, -181, 1242)  # H, window columns, gx0, w_global
TILE = (2, 540, 3840, 128)       # configs/tiled_4k.json: a tile of 2 frames
S_INVALID = 8 * (255 + 100) + 1  # configs/kitti_stereo.json
HBM_BYTES_PER_S = 3.35e12


def card_timing():
    """utils/card_timing.py of this bench's own tree, whichever tree --root
    names, so that both trees are timed by the same code."""
    spec = importlib.util.spec_from_file_location(
        "_fsgm_card_timing", Path(__file__).with_name("card_timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    timing = card_timing()
    root = Path(args.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("k13_bench: no CUDA device available", file=sys.stderr)
        return 1
    from fsgm_tpu_torch.ops.kernels import _build, cost, extract
    from fsgm_tpu_torch.utils.k2_bench import card_line, parse_ptxas

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    takes_bits = "census_bits" in inspect.signature(
        cost.census_cost).parameters

    def words(shape, bits):
        return torch.randint(0, 1 << bits, shape, generator=gen, device=dev,
                             dtype=torch.int64)

    def row(fn, nbytes, **kw):
        dev_ms, _, names = timing.device_profile(fn, args.reps)
        return dict(kw, ms=timing.median_ms(fn, args.reps), device_ms=dev_ms,
                    kernels=names, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    rec = dict(tag=args.tag, card=card_line(), torch=torch.__version__,
               root=str(root), census_bits_arg=takes_bits, sms=sms,
               max_sm_clock_mhz=clock_mhz)
    rec["ptxas"] = {lib: parse_ptxas(_build.ptxas_log(lib))
                    for lib in ("cost", "extract")}

    h, w, d = KITTI
    warm = words((FRAMES, h, w), BITS_9X7)  # the clocks up before timing
    for _ in range(40):
        cost.census_cost(warm, warm, d)
    del warm
    k1 = {}
    for name, b, bits, rr in (("kitti_1", 1, BITS_5X5, False),
                              ("kitti_16", FRAMES, BITS_5X5, False),
                              ("kitti_right", 1, BITS_5X5, True),
                              ("census_9x7", 1, BITS_9X7, False)):
        cl, cr = words((b, h, w), bits), words((b, h, w), bits)
        kw = {"census_bits": bits} if takes_bits else {}
        popc = cost.popcounts_per_byte(bits) if takes_bits else 2
        k1[name] = row(lambda: cost.census_cost(cl, cr, d, 255, rr, **kw),
                       b * h * w * (16 + d), frames=b, bits=bits,
                       right_reference=rr, popc_floor_ms=b * h * w * d * popc
                       / (POPC_PER_CLOCK * sms * clock_mhz * 1e3))
        del cl, cr
    rec["k1"] = k1

    k3 = {}
    s16 = torch.randint(0, 3000, (FRAMES, h, w, d), generator=gen,
                        device=dev, dtype=torch.int16)
    for name, s in (("kitti_1", s16[0]), ("kitti_16", s16)):
        b = s.numel() // (h * w * d)
        for rwta in (True, False):
            k3[f"{name}{'' if rwta else '_no_rwta'}"] = row(
                lambda: extract.extract_stereo(s, S_INVALID, 1, True, rwta),
                b * h * w * (2 * d + (5 if rwta else 4) * 4), frames=b,
                with_rwta=rwta)
    k3["wta_right_kitti_1"] = row(
        lambda: extract.wta_right(s16[0], S_INVALID), h * w * (2 * d + 4))
    del s16
    wh, ww, gx0, wg = WINDOW
    sw = torch.randint(0, 3000, (wh, ww, d), generator=gen, device=dev,
                       dtype=torch.int16)
    k3["kitti_window"] = row(
        lambda: extract.extract_stereo(sw, S_INVALID, 1, True, True, gx0, wg),
        wh * ww * (2 * d + 20), shape=list(sw.shape), gx0=gx0, w_global=wg)
    del sw
    st = torch.randint(0, 3000, TILE, generator=gen, device=dev,
                       dtype=torch.int16)
    tb, th, tw, td = TILE
    k3["config5_tile"] = row(
        lambda: extract.extract_stereo(st, S_INVALID, 1, True, True),
        tb * th * tw * (2 * td + 20), shape=list(TILE))
    rec["k3"] = k3
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
