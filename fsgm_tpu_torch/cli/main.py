"""Command-line interface of the PyTorch port: the ``stereo`` subcommand.

    python -m fsgm_tpu_torch.cli stereo L.png R.png -o d.png \\
        --preset configs/kitti_stereo.json --device cuda

Counterpart of fsgm_tpu/cli/main.py ``stereo`` (``_add_stereo_args``,
``cmd_stereo``); prints the same one-line JSON record.  ``--device``
defaults to ``cuda`` and fails when no card is present; ``--device cpu``
runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from fsgm_tpu_torch import io
from fsgm_tpu_torch.params import SGMParams, load_preset


def _params_from_args(args) -> SGMParams:
    if args.preset:
        for v in load_preset(args.preset).values():
            if isinstance(v, SGMParams):
                return v
        raise SystemExit(f"preset {args.preset} has no SGMParams")
    fields = {f.name for f in dataclasses.fields(SGMParams)}
    kw = {k: v for k, v in vars(args).items()
          if k in fields and v is not None}
    if "census_window" in kw:
        kw["census_window"] = tuple(kw["census_window"])
    return SGMParams(**kw)


def _add_stereo_args(sp) -> None:
    sp.add_argument("--preset", help="configs/*.json preset file")
    sp.add_argument("--max-disp", dest="max_disp", type=int)
    sp.add_argument("--p1", type=int)
    sp.add_argument("--p2", type=int)
    sp.add_argument("--num-paths", dest="num_paths", type=int)
    sp.add_argument("--census-window", dest="census_window", type=int,
                    nargs=2)
    sp.add_argument("--adaptive-p2", dest="adaptive_p2",
                    action="store_true", default=None)
    sp.add_argument("--no-subpixel", dest="subpixel", action="store_false",
                    default=None)
    sp.add_argument("--no-lr-check", dest="lr_check", action="store_false",
                    default=None)
    sp.add_argument("--no-median", dest="median_filter",
                    action="store_false", default=None)
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def cmd_stereo(args) -> int:
    from fsgm_tpu_torch.models.stereo import stereo_sgm

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu for the plain versions)")
    p = _params_from_args(args)
    img_l, img_r = io.load_gray(args.left), io.load_gray(args.right)
    dev = torch.device(args.device)
    t0 = time.perf_counter()
    disp = stereo_sgm(torch.tensor(img_l, device=dev),
                      torch.tensor(img_r, device=dev), p).cpu().numpy()
    dt = time.perf_counter() - t0
    out = Path(args.output)
    if out.suffix == ".pfm":
        io.write_pfm(out, disp)
    else:
        io.write_disparity_png(out, disp)
    rec = {"cmd": "stereo", "left": str(args.left), "out": str(out),
           "h": img_l.shape[0], "w": img_l.shape[1], "d": p.max_disp,
           "wall_s": round(dt, 4),
           "valid_frac": round(float((disp >= 0).mean()), 4)}
    print(json.dumps(rec))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="fsgm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("stereo", help="disparity for a rectified pair")
    sp.add_argument("left")
    sp.add_argument("right")
    sp.add_argument("-o", "--output", required=True)
    _add_stereo_args(sp)
    sp.set_defaults(fn=cmd_stereo)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
