"""K4 (csrc/extract_flow.cu) and min16_probe (csrc/min16_probe.cu) on the
card at the main paths' shapes, one JSON line.

    python fsgm_tpu_torch/utils/k4_bench.py [--root DIR] [--tag NAME] \\
        [--out FILE.json] [--reps 20]

``--root`` imports ``fsgm_tpu_torch`` from DIR instead of this checkout, so
that one command can time two trees of the port on one card in turns (for
example a ``git archive`` of the parent commit beside the working tree:
parent, change, change, parent).  Every input is made on the card from a
seeded generator, so both trees see the same bytes.  It reports for each
row ``ms``, the median over ``--reps`` of one call timed by CUDA events
after two warm-ups (the wrapper's host work included where it outlasts the
kernel, as in chip_smoke.py's phase 7), ``device_ms``, the kernel's own
device time per call from torch.profiler over ``--reps`` calls (the mean
duration of the launches it recorded; ``recorded`` counts them a call),
``host_ms``, the wrapper's host time per call (``--reps`` calls back to
back, not synchronised), and ``bound_ms``, the bytes read and written once
over 3.35 TB/s:

  * ``ptxas``: registers, stack, shared memory and spills of every kernel
    in the tree's extract_flow.cu and min16_probe.cu (``nvcc -Xptxas -v``);
  * ``k4``: extract_flow with subpixel on config 4's four pyramid levels
    (375x1242, 187x621, 93x310, 46x155; 81 labels in 96 slots) in int16
    and int32 S, and on the 4K flow leg's level-0 tile (rows 720..1439 of
    2160x3840, int16).  The bound counts 81 labels a pixel; ``sector_ms``
    counts the 32-byte sectors that hold them (a 192-byte int16 row:
    all six), the least the card can read for them;
  * ``min16``: the five min16_probe forms and torch.minimum (int16 and
    int32) on 2^26 values, chip_smoke.py's size.

Only the card runs this: it exits when torch finds no CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    # Run as a script, this file's directory leads sys.path, and its
    # logging.py would stand in for the standard library's when torch
    # imports logging: take the directory out before anything imports torch.
    _here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _here]

LEVELS = ((375, 1242), (187, 621), (93, 310), (46, 155))  # config 4
UHD_TILE = (720, 3840)  # the 4K flow leg's level-0 row tile (of 3)
NL, EXT, ND = 81, 9, 96
S_MAX = 8 * (255 + 100)  # configs/kitti_flow.json: 8 (invalid + P2)
MIN16_N = 1 << 26
SECTOR = 32
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
        print("k4_bench: no CUDA device available", file=sys.stderr)
        return 1
    from fsgm_tpu_torch.ops.kernels import _build, extract, probe
    from fsgm_tpu_torch.utils.k2_bench import card_line, parse_ptxas

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t * 1e3 / args.reps

    def row(fn, nbytes, **kw):
        dev_ms, recorded, names = timing.device_profile(fn, args.reps)
        return dict(kw, ms=timing.median_ms(fn, args.reps), device_ms=dev_ms,
                    recorded=recorded, host_ms=host_ms(fn), kernels=names,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)

    rec = dict(tag=args.tag, card=card_line(), torch=torch.__version__,
               root=str(root))
    rec["ptxas"] = {lib: parse_ptxas(_build.ptxas_log(lib))
                    for lib in ("extract_flow", "min16_probe")}

    warm = torch.randint(0, S_MAX, (*LEVELS[0], ND), generator=gen,
                         device=dev, dtype=torch.int16)
    for _ in range(40):  # the clocks up before timing
        extract.extract_flow(warm, NL, EXT)
    del warm
    k4 = {}
    shapes = [(f"level{k}", hw, dt) for dt in (torch.int16, torch.int32)
              for k, hw in enumerate(LEVELS)]
    shapes.append(("uhd_tile", UHD_TILE, torch.int16))
    for name, (h, w), dt in shapes:
        s = torch.randint(0, S_MAX, (h, w, ND), generator=gen, device=dev,
                          dtype=dt)
        elem = s.element_size()
        row_sectors = -(-NL * elem // SECTOR)
        tag = f"{name}_{'int16' if dt == torch.int16 else 'int32'}"
        k4[tag] = row(lambda: extract.extract_flow(s, NL, EXT),
                      h * w * (NL * elem + 7 * 4), shape=[h, w, ND],
                      sector_ms=h * w * (row_sectors * SECTOR + 7 * 4)
                      / HBM_BYTES_PER_S * 1e3)
        del s
    rec["k4"] = k4

    a32, b32 = (torch.randint(-32768, 32768, (MIN16_N,), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(2))
    a16, b16 = a32.to(torch.int16), b32.to(torch.int16)
    min16 = {}
    for form in probe.FORMS:
        x, y = (a32, b32) if form == "int32" else (a16, b16)
        min16[form] = row(lambda: probe.min_probe(x, y, form),
                          3 * MIN16_N * x.element_size())
    for name, (x, y) in (("torch_minimum_int16", (a16, b16)),
                         ("torch_minimum_int32", (a32, b32))):
        min16[name] = row(lambda: torch.minimum(x, y),
                          3 * MIN16_N * x.element_size())
    rec["min16"] = min16
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
