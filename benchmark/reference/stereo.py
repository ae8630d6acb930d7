"""Plain reference of SGM stereo as configuration kind "stereo" states it.

census of both views -> Hamming cost against the right view shifted by d
(``invalid_cost`` where x - d < 0) -> S over ``num_paths`` paths (8, or
the 16 with the knight moves), with P2 constant or, under ``adaptive_p2``,
P2'(p) = max(P1 + 1, P2 // max(1, |I(p) - I(p - r)|)) from the left image
along each direction r -> winner-take-all
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
Blocking changes no output: every frame is computed on its own.  The
aggregation holds one L_r and, under ``adaptive_p2``, one P2' table at a
time, so 16 paths peak near 8.

``SMALL`` is the size the benchmark's CPU tests shrink a configuration of
this kind to (every switch as the configuration states it).
"""

from __future__ import annotations

import torch

from benchmark.reference import sgm

INVALID = -1.0

# label-pixels (H * W * D) of the largest block: 16 KITTI frames at D = 128
BLOCK_LABEL_PX = 16 * 375 * 1242 * 128

SMALL = dict(height=40, width=56, params=dict(max_disp=32))

DIRS = {8: sgm.DIRS_8, 16: sgm.DIRS_16}


def _supported(p: dict) -> None:
    want = {"num_paths": (8, 16), "lr_mode": ("s_trick",),
            "fill_invalid": (False,)}
    off = {k: p[k] for k, v in want.items() if p[k] not in v}
    if off:
        raise ValueError(f"the stereo reference covers {want} and either "
                         f"adaptive_p2, got {off}")


def p2_table(img: torch.Tensor, direction, p1: int, p2: int
             ) -> torch.Tensor:
    """(..., H, W) int32 P2' of direction r = (dy, dx) from (..., H, W)
    uint8 img: max(P1 + 1, P2 // max(1, |I(p) - I(p - r)|)) where p - r
    lies inside the frame, P2 elsewhere (never read: L = C there)."""
    y, y_src = sgm.inside(img.shape[-2], direction[0])
    x, x_src = sgm.inside(img.shape[-1], direction[1])
    i = img.to(torch.int32)
    step = (i[..., y, x] - i[..., y_src, x_src]).abs().clamp(min=1)
    out = torch.full(img.shape, p2, dtype=torch.int32, device=img.device)
    out[..., y, x] = (p2 // step).clamp(min=p1 + 1)
    return out


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
    p1, p2 = p["p1"], p["p2"]
    s = sgm.aggregate(cost, p1, (lambda r: p2_table(img_l, r, p1, p2))
                      if p["adaptive_p2"] else p2,
                      dirs=DIRS[p["num_paths"]])
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
        # above any S: L_r <= C + P2' and P2' <= max(P2, P1 + 1)
        s_invalid = p["num_paths"] * (p["invalid_cost"]
                                      + max(p2, p1 + 1)) + 1
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
