"""Plain reference of SGM stereo as configuration kind "stereo" states it.

census of both views -> Hamming cost against the right view shifted by d
(``invalid_cost`` where x - d < 0) -> S over the 8 paths -> winner-take-all
-> parabola refinement -> the left-right check by the S-volume trick (the
right view's disparity at x is argmin_d S(y, x + d, d); a pixel passes
where its rounded disparity d lies in [0, D), x - d >= 0 and the right
view's disparity at x - d is within ``lr_max_diff`` of d) -> 3x3 median,
invalid pixels marked -1.

``run`` is what the harness calls: it takes (F, H, W) uint8 pairs and
gives ((F, H, W) float32 disparity,), frames in blocks of ``block``, so
that the S volumes of a block fit beside the program's outputs.  The
default block (``default_block``) holds no more label-pixels (H * W * D)
than 16 KITTI frames (375 x 1242) at D = 128, and at least one frame: 16
frames at config 2's size, one at 2160 x 3840 (a peak of about 23 GB).
Blocking changes no output: every frame is computed on its own.
"""

from __future__ import annotations

import torch

from benchmark.reference import sgm

INVALID = -1.0

# label-pixels (H * W * D) of the largest block: 16 KITTI frames at D = 128
BLOCK_LABEL_PX = 16 * 375 * 1242 * 128


def _supported(p: dict) -> None:
    want = {"num_paths": 8, "adaptive_p2": False, "lr_mode": "s_trick",
            "fill_invalid": False}
    off = {k: p[k] for k, v in want.items() if p[k] != v}
    if off:
        raise ValueError(f"the stereo reference covers {want}, got {off}")


def cost_volume(cen_l: torch.Tensor, cen_r: torch.Tensor, max_disp: int,
                invalid_cost: int) -> torch.Tensor:
    """(..., H, W, D) uint8: popcount(cenL(x) ^ cenR(x - d)), invalid_cost
    where x - d < 0; one disparity at a time."""
    out = torch.full(cen_l.shape + (max_disp,), invalid_cost,
                     dtype=torch.uint8, device=cen_l.device)
    for d in range(min(max_disp, cen_l.shape[-1])):
        out[..., d:, d] = sgm.hamming(cen_l[..., d:],
                                      cen_r[..., :cen_r.shape[-1] - d])
    return out


def right_disparity(s: torch.Tensor, s_invalid: int) -> torch.Tensor:
    """argmin_d S(y, x + d, d), s_invalid where x + d >= W, int32."""
    w, nd = s.shape[-2:]
    lab = torch.arange(nd, device=s.device)
    src = torch.arange(w, device=s.device)[:, None] + lab[None, :]
    flat = (src.clamp(max=w - 1) * nd + lab).reshape(-1)
    diag = s.reshape(s.shape[:-2] + (w * nd,))[..., flat].reshape(s.shape)
    return sgm.wta(torch.where(src < w, diag, s_invalid))


def lr_valid(disp: torch.Tensor, d_right: torch.Tensor, max_diff: int,
             max_disp: int) -> torch.Tensor:
    w = disp.shape[-1]
    d = torch.round(disp).to(torch.int64)
    src = torch.arange(w, device=disp.device) - d
    inside = (d >= 0) & (d < max_disp) & (src >= 0)
    d_r = torch.gather(d_right.to(torch.int64), -1, src.clamp(0, w - 1))
    return inside & ((d - d_r).abs() <= max_diff)


def disparity(img_l: torch.Tensor, img_r: torch.Tensor, p: dict,
              control: str | None = None) -> torch.Tensor:
    """(..., H, W) uint8 pairs -> (..., H, W) float32 disparity."""
    _supported(p)
    sgm.check_control(control)
    nd = p["max_disp"]
    window = tuple(p["census_window"])
    cost = sgm.lower_cost(cost_volume(sgm.census(img_l, window),
                                      sgm.census(img_r, window), nd,
                                      p["invalid_cost"]), control)
    s = sgm.aggregate(cost, p["p1"], p["p2"])
    del cost
    d_int = sgm.wta(s)
    disp = d_int.to(torch.float32)
    if p["subpixel"]:
        idx = torch.stack([d_int - 1, d_int, d_int + 1], dim=-1).long()
        vals = torch.gather(s, -1, idx.clamp(0, nd - 1))
        vals = torch.where((idx >= 0) & (idx < nd), vals, sgm.BIG)
        off, _ = sgm.parabola_offset(*vals.unbind(-1),
                                     (d_int > 0) & (d_int < nd - 1), control)
        disp = disp + off
    if p["lr_check"]:
        s_invalid = p["num_paths"] * (p["invalid_cost"] + p["p2"]) + 1
        ok = lr_valid(disp, right_disparity(s, s_invalid), p["lr_max_diff"],
                      nd)
        disp = torch.where(ok, disp, INVALID)
    del s
    if p["median_filter"]:
        disp = sgm.median3x3(disp)
    return disp


def default_block(cfg: dict) -> int:
    """Frames a block at the configuration's size (module docstring)."""
    px = cfg["height"] * cfg["width"] * cfg["params"]["max_disp"]
    return max(1, BLOCK_LABEL_PX // px)


def run(imgs_a: torch.Tensor, imgs_b: torch.Tensor, cfg: dict,
        control: str | None = None, block: int | None = None) -> tuple:
    """The reference's outputs for F frames: ((F, H, W) float32,)."""
    block = block or default_block(cfg)
    return (torch.cat([disparity(imgs_a[k:k + block], imgs_b[k:k + block],
                                 cfg["params"], control)
                       for k in range(0, imgs_a.shape[0], block)]),)
