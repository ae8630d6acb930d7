"""Disparity-axis (label) sharding: the cost volume's D labels split into
td slices, slice k on devices[k].

Counterpart of fsgm_tpu/parallel/disparity_sharded.py
(``stereo_sgm_dsharded``).  Useful only for label spaces too large for one
device: every scan step of every path needs the minimum over all labels,
so the slices meet once a step.  Per step and slice:

  * a local min over the slice's labels, then the min across slices (the
    reference's ``pmin``);
  * the d +- 1 neighbour term with a one-label halo from each neighbour
    slice (its ``ppermute``), handed over by ``tensor.to(device)`` as in
    parallel/tiled.py;
  * after the sweeps, the global argmin with the smallest-index tie-break,
    and S at the global labels d* -+ 1 for the parabola.

Everything stays int32 until the subpixel step, so the mode is bit-exact
against stereo_sgm.  The reference is XLA-only by construction (a
collective inside every scan step: no Pallas kernel can hold it), so the
port is plain PyTorch on any device, with no kernel.  The LR check (the
S-volume trick's diagonal, s_invalid past the image), the subpixel step
and the median are ops/extract.py's.  The reference ignores ``lr_mode``
and ``fill_invalid``; the port raises on "reagg" and on fill_invalid
instead.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.census import census_transform, hamming
from fsgm_tpu_torch.ops.kernels.aggregate import p2_effective
from fsgm_tpu_torch.params import SGMParams

INF32 = 1 << 28
BIG = 1 << 24


def _pmin(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise min over every slice's x, on each slice's device."""
    m = functools.reduce(torch.minimum, [x.to(xs[0].device) for x in xs])
    return [m.to(x.device) for x in xs]


def cost_volume_slice(cen_l: torch.Tensor, cen_r: torch.Tensor, d_lo: int,
                      d_local: int, invalid_cost: int) -> torch.Tensor:
    """C[y, x, dl] for the global disparities d_lo + dl, (H, W, d_local)
    uint8: invalid_cost where x - d < 0."""
    w = cen_l.shape[-1]
    xs = torch.arange(w, device=cen_l.device)[:, None]
    src = xs - (d_lo + torch.arange(d_local, device=cen_l.device))[None, :]
    c = hamming(cen_l[..., None], cen_r[..., src.clamp(0, w - 1)])
    return torch.where(src >= 0, c, invalid_cost).to(torch.uint8)


def _neighbor_min_sharded(prevs: Sequence[torch.Tensor], p1: int
                          ) -> list[torch.Tensor]:
    """min(prev[d-1], prev[d+1]) + P1 of each slice, with one-label halos
    from the neighbour slices (INF32 beyond the first and last label);
    prevs: (W, Dl) int32 per slice."""
    n = len(prevs)
    out = []
    for k, prev in enumerate(prevs):
        inf = torch.full_like(prev[:, :1], INF32)
        from_lo = prevs[k - 1][:, -1:].to(prev.device) if k > 0 else inf
        from_hi = prevs[k + 1][:, :1].to(prev.device) if k < n - 1 else inf
        shift_m = torch.cat([from_lo, prev[:, :-1]], dim=1)
        shift_p = torch.cat([prev[:, 1:], from_hi], dim=1)
        out.append(torch.minimum(shift_m, shift_p) + p1)
    return out


def aggregate_one_path_dsharded(costs: Sequence[torch.Tensor],
                                img: torch.Tensor,
                                direction: Tuple[int, int], p1: int, p2: int,
                                adaptive: bool) -> list[torch.Tensor]:
    """One path's L over a label-sharded volume: costs (H, W, Dl) per slice,
    each on its device, img (H, W) the guide; (H, W, Dl) int32 per slice.
    The reference's semantics: a zero start state, the x-bounds validity
    (a pixel whose predecessor leaves the row takes L = C) and adaptive
    P2' (ops/kernels/aggregate.py::p2_effective)."""
    p2e = p2_effective(img, direction, p1, p2, adaptive)
    return _scan(costs, p2e, direction, p1)


def _scan(costs: Sequence[torch.Tensor], p2e: torch.Tensor,
          direction: Tuple[int, int], p1: int) -> list[torch.Tensor]:
    """The recurrence along ``direction``, turned into a scan down the rows
    (dy > 0) by a transpose (dy = 0) or a flip (dy < 0)."""
    dy, dx = direction
    if dy == 0:
        out = _scan([c.transpose(0, 1) for c in costs], p2e.t(), (dx, 0),
                    p1)
        return [x.transpose(0, 1) for x in out]
    if dy < 0:
        out = _scan([c.flip(0) for c in costs], p2e.flip(0), (-dy, dx), p1)
        return [x.flip(0) for x in out]

    h, w, _ = costs[0].shape
    xx = torch.arange(w, device=p2e.device)
    valid_row = ((xx - dx >= 0) & (xx - dx < w))[:, None]
    p2es = [p2e.to(c.device) for c in costs]
    valids = [valid_row.to(c.device) for c in costs]
    # carries[k] = [L of the row above, L of the row two above]
    carries = [[torch.zeros(c.shape[1:], dtype=torch.int32, device=c.device)
                for _ in range(2)] for c in costs]
    rows = [[] for _ in costs]

    def shift_x(row):
        if dx == 0:
            return row
        pad = torch.full_like(row[:abs(dx)], INF32)
        if dx > 0:
            return torch.cat([pad, row[:-dx]], dim=0)
        return torch.cat([row[-dx:], pad], dim=0)

    for y in range(h):
        prevs = [shift_x(c[dy - 1]) for c in carries]
        ms = _pmin([p.amin(dim=-1, keepdim=True) for p in prevs])
        nmins = _neighbor_min_sharded(prevs, p1)
        for k, (prev, m, nmin) in enumerate(zip(prevs, ms, nmins)):
            cost_row = costs[k][y].to(torch.int32)
            best = torch.minimum(torch.minimum(prev, nmin),
                                 m + p2es[k][y][:, None])
            l_row = torch.where(valids[k], cost_row + best - m, cost_row)
            rows[k].append(l_row)
            carries[k] = [l_row, carries[k][0]]
    return [torch.stack(r) for r in rows]


def _global_argmin(vals: Sequence[torch.Tensor], d_los: Sequence[int]):
    """(..., Dl) per slice -> the global (argmin_d, min) per slice's device,
    smallest d on ties."""
    local_min = [v.amin(dim=-1) for v in vals]
    local_arg = [ext.wta(v) + d_lo for v, d_lo in zip(vals, d_los)]
    gmin = _pmin(local_min)
    cand = [torch.where(lm == g, la, 1 << 30)
            for lm, la, g in zip(local_min, local_arg, gmin)]
    return _pmin(cand), gmin


def _sel_global(svs: Sequence[torch.Tensor], targets: Sequence[torch.Tensor],
                d_los: Sequence[int]) -> list[torch.Tensor]:
    """S at the global label ``target`` (BIG outside [0, D)) by a masked
    min on each slice merged across slices."""
    local = []
    for sv, target, d_lo in zip(svs, targets, d_los):
        lane = d_lo + torch.arange(sv.shape[-1], dtype=torch.int32,
                                   device=sv.device)
        local.append(torch.where(lane == target[..., None], sv,
                                 BIG).amin(dim=-1))
    return _pmin(local)


def stereo_sgm_dsharded(img_l: torch.Tensor, img_r: torch.Tensor,
                        params: SGMParams, devices: Sequence) -> torch.Tensor:
    """(H, W) uint8 pair -> (H, W) float32 disparity (INVALID = -1), with
    the D labels split into len(devices) slices, slice k on devices[k];
    bit-identical to stereo_sgm.  The result lies on the images' device."""
    if img_l.shape != img_r.shape or img_l.dim() != 2:
        raise ValueError(f"image shapes {tuple(img_l.shape)} and "
                         f"{tuple(img_r.shape)} must be equal (H, W)")
    td = len(devices)
    if td < 1 or params.max_disp % td:
        raise ValueError(f"max_disp {params.max_disp} must divide by the "
                         f"{td} label slices")
    if params.fill_invalid or (params.lr_check
                               and params.lr_mode == "reagg"):
        raise ValueError("disparity sharding takes neither fill_invalid nor "
                         "lr_mode='reagg'")
    devs = [torch.device(d) for d in devices]
    dl = params.max_disp // td
    d_los = [k * dl for k in range(td)]
    h, w = img_l.shape

    costs = [cost_volume_slice(
        census_transform(img_l.to(dev), params.census_window),
        census_transform(img_r.to(dev), params.census_window), d_lo, dl,
        params.invalid_cost) for dev, d_lo in zip(devs, d_los)]
    s = [torch.zeros((h, w, dl), dtype=torch.int32, device=d) for d in devs]
    for r in params.dirs:
        for acc, l_r in zip(s, aggregate_one_path_dsharded(
                costs, img_l, r, params.p1, params.p2, params.adaptive_p2)):
            acc += l_r
    del costs

    d_int, s0 = _global_argmin(s, d_los)
    disp = d_int[0].to(torch.float32)
    if params.subpixel:
        s_m = _sel_global(s, [d - 1 for d in d_int], d_los)
        s_p = _sel_global(s, [d + 1 for d in d_int], d_los)
        disp = ext.subpixel_from_neighborhood(d_int[0], s_m[0], s0[0],
                                              s_p[0], params.max_disp)
    if params.lr_check:
        # the right view's diagonal S(y, x + d, d) on each slice
        diags = []
        for sv, d_lo in zip(s, d_los):
            src = (torch.arange(w, device=sv.device)[:, None] + d_lo
                   + torch.arange(dl, device=sv.device)[None, :])
            diag = torch.gather(sv, 1, src.clamp(max=w - 1).expand(h, w, dl))
            diags.append(torch.where(src < w, diag, params.s_invalid))
        d_right, _ = _global_argmin(diags, d_los)
        disp = ext.lr_check(disp, d_right[0], params.lr_max_diff,
                            params.max_disp)
    if params.median_filter:
        disp = ext.median_filter_3x3(disp)
    return disp.to(img_l.device)
