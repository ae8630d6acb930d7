"""One step of every parallelism mode on tiny shapes, and the flagship
entry at Tsukuba size.

Counterpart of __graft_entry__.py (``entry``, ``dryrun_multichip``).  The
JAX package builds an n-device mesh; here a mode runs over a list of n
devices, by default n copies of the one card (``cuda:0``), as the tiled
entry points take them.  Beyond the reference's shape checks, each exact
mode equals its untiled counterpart bit for bit.  The tiled stereo modes
search 32 disparities where the reference searches 16 and 8: the card's
K2 and K3 take D a multiple of 32.  The disparity-sharded mode keeps the
reference's D = 8n and is held to stereo_sgm_reference, the plain
composition, which takes any D.
"""

from __future__ import annotations

import numpy as np
import torch

from fsgm_tpu_torch.io.synthetic import constant_flow_pair, random_dot_stereo
from fsgm_tpu_torch.models.flow import flow_fsgm
from fsgm_tpu_torch.models.stereo import (stereo_sgm, stereo_sgm_batch,
                                          stereo_sgm_reference)
from fsgm_tpu_torch.params import DistParams, FlowParams, SGMParams
from fsgm_tpu_torch.parallel.disparity_sharded import stereo_sgm_dsharded
from fsgm_tpu_torch.parallel.tiled import stereo_sgm_sharded
from fsgm_tpu_torch.parallel.tiled_flow import flow_fsgm_sharded


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass device='cpu' "
                           "for the plain versions)")
    return torch.device("cuda", 0)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _stack(pairs, dev: torch.device):
    return tuple(torch.from_numpy(np.stack([p[k] for p in pairs])).to(dev)
                 for k in (0, 1))


def entry(device=None):
    """(fn, args): stereo_sgm at the Tsukuba-size configuration (288x384,
    D=64, 8 paths) on ``device`` (default: the card)."""
    dev = _device(device)
    params = SGMParams(max_disp=64, p1=7, p2=100, num_paths=8)
    img_l, img_r, _ = random_dot_stereo(288, 384, 64, seed=0)

    def fn(il, ir):
        return stereo_sgm(il, ir, params)

    return fn, (torch.from_numpy(img_l).to(dev),
                torch.from_numpy(img_r).to(dev))


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded step of each mode over n_devices devices (n copies of
    ``device``, default the card):

    1. stereo over (frame, ty), exact (== stereo_sgm_batch) and fast;
    2. fSGM flow over the same grid, exact (== flow_fsgm per frame);
       frame = 2 only where that leaves ty >= 2 (n even and >= 4), so
       that the flow mode crosses row tiles wherever n > 1; at n = 1 a
       frame is flow_fsgm itself and the mode checks only its shapes;
    3. stereo over (frame, ty, tx) where 4 divides n (== stereo_sgm_batch:
       the column windows span the image at this size);
    4. stereo with the labels over n slices (== stereo_sgm_reference).
    """
    dev = _device(device)
    devices = [dev] * n_devices

    # 1 + 2. frame x ty
    frame = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    ty = n_devices // frame
    params = SGMParams(max_disp=32, p1=7, p2=60, num_paths=8)
    dist = DistParams(tiles_y=ty, frame_shards=frame, tile_mode="exact")
    levels = 2
    h, w = 8 * ty * (1 << (levels - 1)), 40
    img_l, img_r = _stack([random_dot_stereo(h, w, 16, seed=s)
                           for s in range(frame)], dev)
    out = stereo_sgm_sharded(img_l, img_r, params, dist, devices)
    _require(out.shape == (frame, h, w), f"stereo shape {out.shape}")
    _require(torch.equal(out, stereo_sgm_batch(img_l, img_r, params)),
             f"(frame, ty) = {(frame, ty)} exact stereo != stereo_sgm_batch")
    dist_f = DistParams(tiles_y=ty, frame_shards=frame, tile_mode="fast",
                        margin=4)
    out_f = stereo_sgm_sharded(img_l, img_r, params, dist_f, devices)
    _require(out_f.shape == (frame, h, w), f"fast shape {out_f.shape}")

    fparams = FlowParams(search_radius=2, levels=levels, p1=7, p2=60)
    i1, i2 = _stack([constant_flow_pair(h, w, 1, -1, seed=s)
                     for s in range(frame)], dev)
    fout, fvalid = flow_fsgm_sharded(i1, i2, fparams, dist, devices)
    _require(fout.shape == (frame, h, w, 2)
             and fvalid.shape == (frame, h, w),
             f"flow shapes {fout.shape}, {fvalid.shape}")
    for k in range(frame):
        want, want_valid = flow_fsgm(i1[k], i2[k], fparams)
        _require(torch.equal(fout[k], want)
                 and torch.equal(fvalid[k], want_valid),
                 f"(frame, ty) = {(frame, ty)} flow frame {k} != flow_fsgm")

    # 3. frame x ty x tx
    if n_devices % 4 == 0:
        f3, ty3, tx3 = 2, n_devices // 4, 2
        dist3 = DistParams(tiles_y=ty3, tiles_x=tx3, frame_shards=f3,
                           tile_mode="exact")
        p3 = SGMParams(max_disp=32, p1=7, p2=60, num_paths=8)
        h3, w3 = 8 * ty3, 16 * tx3
        il3, ir3 = _stack([random_dot_stereo(h3, w3, 8, seed=s)
                           for s in range(f3)], dev)
        out3 = stereo_sgm_sharded(il3, ir3, p3, dist3, devices)
        _require(out3.shape == (f3, h3, w3), f"2D tiles shape {out3.shape}")
        _require(torch.equal(out3, stereo_sgm_batch(il3, ir3, p3)),
                 f"(frame, ty, tx) = {(f3, ty3, tx3)} stereo != "
                 f"stereo_sgm_batch")

    # 4. the labels over n slices
    dparams = SGMParams(max_disp=8 * n_devices, p1=7, p2=60)
    il, ir, _ = random_dot_stereo(24, 8 * n_devices + 8, 8, seed=0)
    il, ir = torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev)
    dout = stereo_sgm_dsharded(il, ir, dparams, devices)
    _require(dout.shape == il.shape, f"td shape {dout.shape}")
    _require(torch.equal(dout, stereo_sgm_reference(il, ir, dparams)),
             f"td = {n_devices} disparity sharding != stereo_sgm_reference")
