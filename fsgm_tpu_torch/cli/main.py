"""Command-line interface of the PyTorch port: ``stereo`` and ``flow``.

    python -m fsgm_tpu_torch.cli stereo L.png R.png -o d.png \\
        --preset configs/kitti_stereo.json --device cuda
    python -m fsgm_tpu_torch.cli flow A.png B.png -o f.png \\
        --preset configs/kitti_flow.json --device cuda

Counterpart of fsgm_tpu/cli/main.py ``stereo`` and ``flow``
(``cmd_stereo``, ``cmd_flow``, ``densify_flow``); each prints the same
one-line JSON record.  ``--device`` defaults to ``cuda`` and fails when no
card is present; ``--device cpu`` runs the plain PyTorch versions of the
kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from fsgm_tpu_torch import io
from fsgm_tpu_torch.params import FlowParams, SGMParams, load_preset


def _params_from_args(args, cls):
    if args.preset:
        for v in load_preset(args.preset).values():
            if isinstance(v, cls):
                return v
        raise SystemExit(f"preset {args.preset} has no {cls.__name__}")
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in vars(args).items()
          if k in fields and v is not None}
    if "census_window" in kw:
        kw["census_window"] = tuple(kw["census_window"])
    return cls(**kw)


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu for the plain versions)")
    return torch.device(name)


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

    dev = _device(args.device)
    p = _params_from_args(args, SGMParams)
    img_l, img_r = io.load_gray(args.left), io.load_gray(args.right)
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


def densify_flow(flow: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Fill FB-invalidated pixels row-wise from the nearest valid left
    neighbour (else the nearest right one); rows with no valid pixel keep
    their values.  Host-side post-processing for writing dense maps."""
    h, w = valid.shape
    xs = np.arange(w, dtype=np.int64)[None, :]
    left = np.maximum.accumulate(np.where(valid, xs, -1), axis=1)
    right = np.minimum.accumulate(
        np.where(valid, xs, 1 << 30)[:, ::-1], axis=1)[:, ::-1]
    src = np.where(left >= 0, left, right)
    filled = flow[np.arange(h)[:, None], np.clip(src, 0, w - 1)]
    any_valid = valid.any(axis=1, keepdims=True)
    return np.where((valid | ~any_valid)[..., None], flow, filled)


def cmd_flow(args) -> int:
    from fsgm_tpu_torch.models.flow import flow_fsgm

    dev = _device(args.device)
    p = _params_from_args(args, FlowParams)
    img1, img2 = io.load_gray(args.first), io.load_gray(args.second)
    t0 = time.perf_counter()
    flow, valid = flow_fsgm(torch.tensor(img1, device=dev),
                            torch.tensor(img2, device=dev), p)
    flow, valid = flow.cpu().numpy(), valid.cpu().numpy()
    dt = time.perf_counter() - t0
    out = Path(args.output)
    if args.fill_invalid:
        wr, wr_valid = densify_flow(flow, valid), np.ones_like(valid)
    else:
        wr, wr_valid = np.where(valid[..., None], flow, 0), valid
    if out.suffix == ".flo":
        io.write_flo(out, wr)
    else:
        io.write_flow_png(out, wr, wr_valid)
    print(json.dumps({"cmd": "flow", "out": str(out),
                      "wall_s": round(dt, 4),
                      "valid_frac": round(float(valid.mean()), 4)}))
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
    fp = sub.add_parser("flow", help="fSGM optical flow for an image pair")
    fp.add_argument("first")
    fp.add_argument("second")
    fp.add_argument("-o", "--output", required=True)
    fp.add_argument("--preset", help="configs/*.json preset file")
    fp.add_argument("--search-radius", dest="search_radius", type=int)
    fp.add_argument("--levels", type=int)
    fp.add_argument("--p1", type=int)
    fp.add_argument("--p2", type=int)
    fp.add_argument("--fill-invalid", dest="fill_invalid",
                    action="store_true",
                    help="densify: fill FB-invalidated pixels from the "
                    "nearest valid row neighbour")
    fp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    fp.set_defaults(fn=cmd_flow)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
