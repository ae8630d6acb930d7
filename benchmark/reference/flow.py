"""Plain reference of fSGM optical flow as configuration kind "flow" states
it.

A pyramid of ``levels`` images (level 0 the frame; each next level the
2x2 box mean of the last, rounded half up, its size halved and floored),
census at every level, and a coarse-to-fine pass from the coarsest level
with a zero prior.  At each level, over the (2r+1)^2 labels (du, dv) in
[-r, r]^2, label l = (dv + r)(2r + 1) + (du + r), around the rounded prior
(base_u, base_v):

    W(y, x)    = cen2(y + base_v(y, x), x + base_u(y, x)), invalid where
                 that lies outside the image;
    C(y, x, l) = popcount(cen1(y, x) ^ W(y + dv, x + du)), invalid_cost
                 where W is invalid there or (y + dv, x + du) is outside;

then S over the 8 paths with the 2D label rule (a label's neighbours are
the four next to it in the label grid), winner-take-all, a parabola along
u and along v through the winner's grid neighbours (the winner's own row
or column clamped one label inside the grid), and the 3x3 median of u and
of v.  The next level's prior is the flow upsampled 2x by nearest
neighbour (edge rows and columns repeated) with its values doubled.

The forward-backward check runs the same pass from the second image to the
first (``fb_backward`` "full": down to level 0; "half": down to level 1)
and marks a pixel valid where |F(p) + B(p + round(F(p)))| <= fb_max_diff,
the lookup inside the image.  ``fb_grid`` "half" checks both fields box-
downsampled 2x (the backward one already at level 1 under "half") with
half the tolerance and upsamples the validity plane by nearest neighbour.

``run`` takes (F, H, W) uint8 pairs and gives ((F, H, W, 2) float32 flow,
(F, H, W) bool validity), the frames in blocks of ``block``; each level
runs the forward and backward passes of a block as one stack of slices.
The default block (``default_block``) holds no more label-pixels (H * W *
labels at level 0) than 8 KITTI frames (375 x 1242) at 81 labels, and at
least one frame: 8 frames at config 4's size.  Blocking changes no output:
every frame is computed on its own.

``SMALL`` is the size the benchmark's CPU tests shrink a configuration of
this kind to (every switch as the configuration states it).
"""

from __future__ import annotations

import torch

from benchmark.reference import sgm

# label-pixels (H * W * labels) of the largest block: 8 KITTI frames at 81
BLOCK_LABEL_PX = 8 * 375 * 1242 * 81

SMALL = dict(height=40, width=56, params=dict(levels=2, search_radius=2))


def _supported(p: dict) -> None:
    off = {k: p[k] for k in ("adaptive_p2",) if p[k]}
    if p["fb_check"] and p["fb_backward"] not in ("full", "half"):
        off["fb_backward"] = p["fb_backward"]
    if off:
        raise ValueError(f"the flow reference covers no adaptive P2 and "
                         f"fb_backward full or half, got {off}")


def downsample_image(img: torch.Tensor) -> torch.Tensor:
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    s = img[..., :2 * h2, :2 * w2].to(torch.int32).reshape(
        img.shape[:-2] + (h2, 2, w2, 2))
    return ((s.sum(dim=(-3, -1)) + 2) // 4).to(img.dtype)


def downsample_flow(flow: torch.Tensor) -> torch.Tensor:
    """2x2 box mean of (..., H, W, 2), values halved, summed as
    ((a + b) + c) + d (another order can move a rounded window centre)."""
    h2, w2 = flow.shape[-3] // 2, flow.shape[-2] // 2
    x = flow[..., :2 * h2, :2 * w2, :].reshape(
        flow.shape[:-3] + (h2, 2, w2, 2, flow.shape[-1]))
    return (x[..., :, 0, :, 0, :] + x[..., :, 0, :, 1, :]
            + x[..., :, 1, :, 0, :] + x[..., :, 1, :, 1, :]) * 0.125


def upsample_nearest(x: torch.Tensor, out_h: int, out_w: int,
                     row_dim: int) -> torch.Tensor:
    rows = (torch.arange(out_h, device=x.device) // 2).clamp(
        max=x.shape[row_dim] - 1)
    cols = (torch.arange(out_w, device=x.device) // 2).clamp(
        max=x.shape[row_dim + 1] - 1)
    return x.index_select(row_dim, rows).index_select(row_dim + 1, cols)


def cost_volume(cen1: torch.Tensor, cen2: torch.Tensor, base_u: torch.Tensor,
                base_v: torch.Tensor, r: int, invalid_cost: int
                ) -> torch.Tensor:
    """(N, H, W, (2r+1)^2) uint8 over N slices, one label at a time."""
    n, h, w = cen1.shape
    dev = cen1.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    sy, sx = yy + base_v, xx + base_u
    ok = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    frame = torch.arange(n, device=dev)[:, None, None] * (h * w)
    warped = cen2.reshape(-1)[frame + sy.clamp(0, h - 1) * w
                              + sx.clamp(0, w - 1)]
    # a border of r invalid pixels makes every window position addressable
    wp = torch.zeros((n, h + 2 * r, w + 2 * r), dtype=torch.int64,
                     device=dev)
    okp = torch.zeros((n, h + 2 * r, w + 2 * r), dtype=torch.bool,
                      device=dev)
    wp[:, r:r + h, r:r + w] = warped
    okp[:, r:r + h, r:r + w] = ok
    e = 2 * r + 1
    out = torch.empty((n, h, w, e * e), dtype=torch.uint8, device=dev)
    for iv in range(e):
        for iu in range(e):
            win = wp[:, iv:iv + h, iu:iu + w]
            out[..., iv * e + iu] = torch.where(
                okp[:, iv:iv + h, iu:iu + w], sgm.hamming(cen1, win),
                invalid_cost).to(torch.uint8)
    return out


def _level(cen1, cen2, prior, p: dict, control):
    """One level over N slices: (N, H, W, 2) flow from (N, H, W, 2) prior."""
    r = p["search_radius"]
    e = 2 * r + 1
    base_u = torch.round(prior[..., 0]).to(torch.int32)
    base_v = torch.round(prior[..., 1]).to(torch.int32)
    cost = sgm.lower_cost(cost_volume(cen1, cen2, base_u, base_v, r,
                                      p["invalid_cost"]), control)
    s = sgm.aggregate(cost, p["p1"], p["p2"], label_ext=e)
    del cost
    lab = sgm.wta(s)
    iv = lab // e
    iu = lab - iv * e
    u = (base_u + (iu - r)).to(torch.float32)
    v = (base_v + (iv - r)).to(torch.float32)
    if p["subpixel"]:
        bu = iv * e + iu.clamp(1, e - 2)
        bv = iv.clamp(1, e - 2) * e + iu
        idx = torch.stack([bu - 1, bu, bu + 1, bv - e, bv, bv + e], dim=-1)
        vals = torch.gather(s, -1, idx.long()).unbind(-1)
        du, _ = sgm.parabola_offset(*vals[:3], (iu > 0) & (iu < e - 1),
                                    control)
        dv, _ = sgm.parabola_offset(*vals[3:], (iv > 0) & (iv < e - 1),
                                    control)
        u, v = u + du, v + dv
    del s
    if p["median_filter"]:
        u, v = sgm.median3x3(u), sgm.median3x3(v)
    return torch.stack([u, v], dim=-1)


def fb_valid(fwd: torch.Tensor, bwd: torch.Tensor, max_diff: float
             ) -> torch.Tensor:
    """(F, H, W) bool: |F(p) + B(p + round(F(p)))| <= max_diff, the lookup
    inside the image."""
    f, h, w = fwd.shape[:3]
    dev = fwd.device
    yy = torch.arange(h, device=dev, dtype=torch.int32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.int32)[None, :]
    tx = xx + torch.round(fwd[..., 0]).to(torch.int32)
    ty = yy + torch.round(fwd[..., 1]).to(torch.int32)
    inb = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    src = (torch.arange(f, device=dev).view(f, 1, 1) * (h * w)
           + ty.clamp(0, h - 1).long() * w + tx.clamp(0, w - 1))
    b = bwd.reshape(-1, 2)[src]
    err = torch.sqrt((fwd[..., 0] + b[..., 0]) ** 2
                     + (fwd[..., 1] + b[..., 1]) ** 2)
    return inb & (err <= max_diff)


def flow(img1: torch.Tensor, img2: torch.Tensor, p: dict,
         control: str | None = None):
    """(F, H, W) uint8 pairs -> ((F, H, W, 2) float32, (F, H, W) bool)."""
    _supported(p)
    sgm.check_control(control)
    window = tuple(p["census_window"])
    f, h, w = img1.shape
    pyr1, pyr2 = [img1], [img2]
    for _ in range(p["levels"] - 1):
        pyr1.append(downsample_image(pyr1[-1]))
        pyr2.append(downsample_image(pyr2[-1]))
    cen1 = [sgm.census(x, window) for x in pyr1]
    cen2 = [sgm.census(x, window) for x in pyr2]
    # the backward pass runs down to level `stop` (levels - 1 ... stop)
    stop = p["levels"] if not p["fb_check"] else (
        1 if p["fb_backward"] == "half" else 0)
    top = pyr1[-1].shape
    fwd = torch.zeros(top + (2,), dtype=torch.float32, device=img1.device)
    bwd = torch.zeros_like(fwd)
    for lvl in range(p["levels"] - 1, -1, -1):
        lh, lw = pyr1[lvl].shape[-2:]
        both = lvl >= stop
        if lvl < p["levels"] - 1:
            fwd = upsample_nearest(fwd, lh, lw, -3) * 2.0
            if both:
                bwd = upsample_nearest(bwd, lh, lw, -3) * 2.0
        if not both:
            fwd = _level(cen1[lvl], cen2[lvl], fwd, p, control)
            continue
        out = _level(torch.cat([cen1[lvl], cen2[lvl]]),
                     torch.cat([cen2[lvl], cen1[lvl]]),
                     torch.cat([fwd, bwd]), p, control)
        fwd, bwd = out[:f], out[f:]
    if not p["fb_check"]:
        return fwd, torch.ones((f, h, w), dtype=torch.bool,
                               device=img1.device)
    if p["fb_grid"] == "half":
        back = bwd if stop == 1 else downsample_flow(bwd)
        valid = fb_valid(downsample_flow(fwd), back, p["fb_max_diff"] * 0.5)
        return fwd, upsample_nearest(valid, h, w, -2)
    if stop == 1:
        bwd = upsample_nearest(bwd, h, w, -3) * 2.0
    return fwd, fb_valid(fwd, bwd, p["fb_max_diff"])


def default_block(cfg: dict) -> int:
    """Frames a block at the configuration's size (module docstring)."""
    labels = (2 * cfg["params"]["search_radius"] + 1) ** 2
    return max(1, BLOCK_LABEL_PX // (cfg["height"] * cfg["width"] * labels))


def run(imgs_a: torch.Tensor, imgs_b: torch.Tensor, cfg: dict,
        control: str | None = None, block: int | None = None) -> tuple:
    """The reference's outputs for F frames: (flow, validity)."""
    block = block or default_block(cfg)
    outs = [flow(imgs_a[k:k + block], imgs_b[k:k + block], cfg["params"],
                 control) for k in range(0, imgs_a.shape[0], block)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))
