"""Tiled fSGM flow over a grid of devices: frame shards x row tiles, in one
process or with the frame shards over ranks (a RankMesh, as
parallel/tiled.py).

Counterpart of fsgm_tpu/parallel/tiled_flow.py (``flow_fsgm_sharded``),
on the tile lists of parallel/tiled.py.  Per pyramid level, coarsest
first, on each row tile:

    census (``halo`` true rows of each neighbour) -> the label-major flow
    cost in tiled mode (ops/cost.py: the full second image, the prior flow
    extended by ``radius`` true rows of each neighbour) -> K5 -> K2 x 8
    with the 2D label rule, the vertical families carried across the seams
    (parallel/tiled.py::aggregate_tiled, "exact" or "fast") -> K4 and the
    parabola -> the median over one exchanged row.

The second image's pyramid and census are of the whole image: every tile
gathers its rows (the 2D search is vertically unbounded), and a device
that holds several tiles builds them once.  The pyramid runs per tile, so
H must divide by tiles_y * 2^(levels-1).  The forward-backward check
gathers the backward field and checks each tile's rows in global rows;
every ``fb_backward`` mode runs as in models/flow.py.  The frames of a
shard run one after another (the flow kernels K4 and K5 take one frame);
a chain of one row tile is flow_fsgm itself.

One fault of the reference is refused instead of copied: it always checks
on the full grid, also under ``fb_grid="half"``; the port raises where
there are several row tiles.
"""

from __future__ import annotations

import dataclasses

import torch

from fsgm_tpu_torch.params import DIRS_8, DistParams, FlowParams
from fsgm_tpu_torch.models.flow import (_level_extract, build_pyramid,
                                        fb_check, flow_fsgm,
                                        upsample_flow_2x)
from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.cost import cost_volume_flow_major
from fsgm_tpu_torch.ops.kernels import aggregate as agg
from fsgm_tpu_torch.ops.kernels import transpose
from fsgm_tpu_torch.parallel.multihost import RankMesh, run_rank_shards
from fsgm_tpu_torch.parallel.tiled import (aggregate_tiled, device_grid,
                                           exchange_row_halo, gather_rows,
                                           per_device, tile_margin)


def _flow_level(i1: list, i2_full: list, prior: list, params: FlowParams,
                dist: DistParams, counters: dict | None) -> list:
    """One pyramid level on a chain of row tiles: i1 the (Ht, W) tiles of
    the first image, i2_full the whole second image on each tile's device,
    prior the (Ht, W, 2) prior flow tiles -> the level's flow tiles."""
    ht = i1[0].shape[0]
    halo = max(params.census_window[0] // 2, 2)
    i1_ext = exchange_row_halo(i1, halo, counters)
    cen1 = [census_transform(x, params.census_window)[halo:-halo]
            for x in i1_ext]
    cen2 = per_device(lambda x: census_transform(x, params.census_window),
                      i2_full)
    r, e, nl = params.search_radius, params.window_extent, params.num_labels
    prior_ext = exchange_row_halo(prior, r, counters, dim=0)
    base_u = [torch.round(f[..., 0]).to(torch.int32) for f in prior_ext]
    base_v = [torch.round(f[..., 1]).to(torch.int32) for f in prior_ext]
    costs = [transpose.label_minor_from_major(cost_volume_flow_major(
        c1, c2, bu, bv, r, params.invalid_cost, nl_pad=-(-nl // 32) * 32,
        y_offset=k * ht))
        for k, (c1, c2, bu, bv) in enumerate(zip(cen1, cen2, base_u,
                                                  base_v))]
    halos = [(x[halo - 2:halo], x[halo + ht:halo + ht + 2]) for x in i1_ext]
    s = aggregate_tiled(costs, i1, halos, DIRS_8, params.p1, params.p2,
                        params.adaptive_p2, dist.tile_mode,
                        tile_margin(params, dist), counters,
                        agg.plan_dtypes(8 * (params.invalid_cost
                                             + params.p2)),
                        label_ext=e, nl=nl)
    del costs
    unfiltered = dataclasses.replace(params, median_filter=False)
    flow = [_level_extract(sk, bu[r:r + ht], bv[r:r + ht], unfiltered,
                           plain=False)
            for sk, bu, bv in zip(s, base_u, base_v)]
    if params.median_filter:
        flow = [torch.stack([ext.median_filter_3x3(f[..., 0]),
                             ext.median_filter_3x3(f[..., 1])], -1)[1:-1]
                for f in exchange_row_halo(flow, 1, counters, dim=0)]
    return flow


def _flow_oneway(t1: list, t2: list, params: FlowParams, dist: DistParams,
                 counters: dict | None, stop_level: int = 0,
                 final_params: FlowParams | None = None) -> list:
    """Coarse-to-fine pass on row tiles down to ``stop_level``;
    ``final_params`` replaces ``params`` at that level (fb_backward
    "cheap")."""
    pyr1 = [build_pyramid(x, params.levels) for x in t1]
    pyr2 = per_device(lambda x: build_pyramid(x, params.levels),
                      gather_rows(t2, counters))
    flow = [torch.zeros(p[-1].shape + (2,), dtype=torch.float32,
                        device=p[-1].device) for p in pyr1]
    for lvl in range(params.levels - 1, stop_level - 1, -1):
        i1 = [p[lvl] for p in pyr1]
        if lvl < params.levels - 1:
            flow = [upsample_flow_2x(f, x.shape[0], x.shape[1])
                    for f, x in zip(flow, i1)]
        p_lvl = (final_params if lvl == stop_level
                 and final_params is not None else params)
        flow = _flow_level(i1, [p[lvl] for p in pyr2], flow, p_lvl, dist,
                           counters)
    return flow


def _flow_chain(t1: list, t2: list, params: FlowParams, dist: DistParams,
                counters: dict | None):
    """One frame on a chain of row tiles -> (flow tiles, validity tiles)."""
    flow = _flow_oneway(t1, t2, params, dist, counters)
    if not params.fb_check:
        return flow, [torch.ones(f.shape[:2], dtype=torch.bool,
                                 device=f.device) for f in flow]
    nosub = dataclasses.replace(params, subpixel=False, median_filter=False)
    if params.fb_backward == "single":
        bwd = _flow_level(t2, gather_rows(t1, counters), [-f for f in flow],
                          nosub, dist, counters)
    elif params.fb_backward == "half":
        bwd = [upsample_flow_2x(b, f.shape[0], f.shape[1])
               for b, f in zip(_flow_oneway(t2, t1, params, dist, counters,
                                            stop_level=1), flow)]
    else:
        bwd = _flow_oneway(t2, t1, params, dist, counters, final_params=(
            nosub if params.fb_backward == "cheap" else None))
    ht = flow[0].shape[0]
    valid = [fb_check(f, b, params.fb_max_diff, y0=k * ht)
             for k, (f, b) in enumerate(zip(flow, gather_rows(bwd,
                                                              counters)))]
    return flow, valid


def flow_fsgm_sharded(imgs1: torch.Tensor, imgs2: torch.Tensor,
                      params: FlowParams, dist: DistParams, devices=None,
                      counters: dict | None = None):
    """(F, H, W) uint8 pairs -> (flow (F, H, W, 2) float32, valid (F, H, W)
    bool), each frame bit-identical to flow_fsgm in "exact" mode.

    F is split into dist.frame_shards shards and rows into dist.tiles_y
    tiles: F must divide by frame_shards and, with several row tiles, H by
    tiles_y * 2^(levels-1); tiles_x must be 1.  With one row tile a frame
    is flow_fsgm on the tile's device (any H, every fb_grid): no row
    crosses a tile, and ``counters`` is left as it was given.
    ``devices``: a frame_shards x tiles_y list in (frame, ty) order
    (default: every tile on the images' device), or this rank's RankMesh
    (as parallel/tiled.py::stereo_sgm_sharded); ``counters``: as
    stereo_sgm_sharded.  The result lies on the images' device."""
    if imgs1.shape != imgs2.shape or imgs1.dim() != 3:
        raise ValueError(f"image shapes {tuple(imgs1.shape)} and "
                         f"{tuple(imgs2.shape)} must be equal (F, H, W)")
    if imgs1.device != imgs2.device:
        raise ValueError("images lie on different devices")
    f, h, w = imgs1.shape
    fs, ty = dist.frame_shards, dist.tiles_y
    if f % fs or (ty > 1 and h % (ty << (params.levels - 1))) \
            or dist.tiles_x != 1:
        raise ValueError(f"(F, H) = {(f, h)} must divide by (frame_shards, "
                         f"tiles_y * 2^(levels-1)) = "
                         f"{(fs, ty << (params.levels - 1))}, and tiles_x "
                         f"must be 1 (got {dist.tiles_x})")
    if ty > 1 and params.fb_check and params.fb_grid == "half":
        raise ValueError("fb_grid='half' is not supported under row tiling")
    if isinstance(devices, RankMesh):
        return run_rank_shards(
            devices, dist, lambda a, b, d, devs: _flow_frames(
                a, b, params, d, devs, counters), imgs1, imgs2)
    return _flow_frames(imgs1, imgs2, params, dist, devices, counters)


def _flow_frames(imgs1: torch.Tensor, imgs2: torch.Tensor,
                 params: FlowParams, dist: DistParams, devices,
                 counters: dict | None):
    f, h, w = imgs1.shape
    fs, ty = dist.frame_shards, dist.tiles_y
    grid = device_grid(devices, (fs, ty), imgs1.device)
    fl, ht = f // fs, h // ty
    flows = torch.empty((f, h, w, 2), dtype=torch.float32,
                        device=imgs1.device)
    valids = torch.empty((f, h, w), dtype=torch.bool, device=imgs1.device)
    for n in range(f):
        devs = grid[n // fl]
        t1, t2 = ([img[n, y * ht:(y + 1) * ht].to(devs[y]).contiguous()
                   for y in range(ty)] for img in (imgs1, imgs2))
        if ty > 1:
            flow, valid = _flow_chain(t1, t2, params, dist, counters)
        else:
            flow, valid = ([x] for x in flow_fsgm(t1[0], t2[0], params))
        for y in range(ty):
            flows[n, y * ht:(y + 1) * ht] = flow[y].to(flows.device)
            valids[n, y * ht:(y + 1) * ht] = valid[y].to(valids.device)
    return flows, valids
