"""K5 (csrc/transpose.cu, label_minor_from_major) on the card at the flow
paths' shapes, one JSON line.

    python fsgm_tpu_torch/utils/k5_bench.py [--root DIR] [--tag NAME] \\
        [--out FILE.json] [--reps 20]

``--root`` imports ``fsgm_tpu_torch`` from DIR instead of this checkout, so
that one command can time two trees of the port on one card in turns (for
example a ``git archive`` of the parent commit beside the working tree:
parent, change, change, parent).  Every input is made on the card from a
seeded generator, so both trees see the same bytes.  Each row holds
``ms``, the median over ``--reps`` of one call timed by CUDA events after
two warm-ups (the wrapper's host work included where it outlasts the
kernel), ``device_ms``, the kernel's own device time per call from
torch.profiler over ``--reps`` calls (``recorded`` counts the launches it
saw a call), ``host_ms``, the wrapper's host time per call (``--reps``
calls back to back, not synchronised), ``bound_ms``, the volume read once
and written once (2 H L W bytes) over 3.35 TB/s, ``sector_ms``, the
32-byte sectors that the kernel's tiles touch (``sector_bytes``: each
tile's input rows and its output span, every sector a tile touches
counted for that tile), and ``library_ms`` / ``library_device_ms``, the
same for ``transpose(1, 2).contiguous()`` on the same volume:

  * ``ptxas``: registers, stack, shared memory and spills of every kernel
    in the tree's transpose.cu (``nvcc -Xptxas -v``);
  * ``k5``: config 4's four pyramid levels (375x1242, 187x621, 93x310,
    46x155; 81 labels in 96 slots), the 4K flow leg's level-0 row tile
    (720x3840, 96 slots) and 37x53 with 32 slots.

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

import numpy as np

# (name, H, L, W): config 4's levels, the 4K flow tile, the small check
SHAPES = (("level0", 375, 96, 1242), ("level1", 187, 96, 621),
          ("level2", 93, 96, 310), ("level3", 46, 96, 155),
          ("uhd_tile", 720, 96, 3840), ("small", 37, 32, 53))
TILE_W = 128  # columns of one K5 tile (csrc/transpose.cu kTileW)
SECTOR = 32
HBM_BYTES_PER_S = 3.35e12


def sector_bytes(h: int, nl: int, w: int, tile_w: int = TILE_W) -> int:
    """Bytes of the 32-byte sectors that K5's tiles touch on an (H, L, W)
    volume at a 32-byte aligned base: tile (y, x0) reads columns x0 ...
    x0 + n - 1 (n = min(tile_w, W - x0)) of each of plane y's L rows and
    writes the contiguous output span of n L bytes; a sector that two
    tiles touch counts for both."""
    rows = np.arange(h * nl, dtype=np.int64) * w
    spans = np.arange(h, dtype=np.int64) * w * nl
    total = 0
    for x0 in range(0, w, tile_w):
        n = min(tile_w, w - x0)
        for start, size in ((rows + x0, n), (spans + x0 * nl, n * nl)):
            total += int(((start + size - 1) // SECTOR - start // SECTOR
                          + 1).sum())
    return total * SECTOR


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
        print("k5_bench: no CUDA device available", file=sys.stderr)
        return 1
    from fsgm_tpu_torch.ops.kernels import _build, transpose
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

    rec = dict(tag=args.tag, card=card_line(), torch=torch.__version__,
               root=str(root))
    rec["ptxas"] = parse_ptxas(_build.ptxas_log("transpose"))

    def volume(h, nl, w):
        return torch.randint(0, 256, (h, nl, w), generator=gen, device=dev,
                             dtype=torch.uint8)

    warm = volume(*SHAPES[0][1:])
    for _ in range(40):  # the clocks up before timing
        transpose.label_minor_from_major(warm)
    del warm
    k5 = {}
    for name, h, nl, w in SHAPES:
        vol = volume(h, nl, w)
        ok = torch.equal(transpose.label_minor_from_major(vol),
                         transpose.label_minor_from_major_plain(vol))
        kern = lambda: transpose.label_minor_from_major(vol)  # noqa: E731
        lib = lambda: vol.transpose(1, 2).contiguous()  # noqa: E731
        dev_ms, recorded, names = timing.device_profile(kern, args.reps)
        k5[name] = dict(
            shape=[h, nl, w], equal_plain=ok,
            ms=timing.median_ms(kern, args.reps), device_ms=dev_ms,
            recorded=recorded, host_ms=host_ms(kern), kernels=names,
            bound_ms=2 * h * nl * w / HBM_BYTES_PER_S * 1e3,
            sector_ms=sector_bytes(h, nl, w) / HBM_BYTES_PER_S * 1e3,
            library_ms=timing.median_ms(lib, args.reps),
            library_device_ms=timing.device_ms(lib, args.reps))
        del vol
    rec["k5"] = k5
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if all(r["equal_plain"] for r in k5.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
