"""Tiled fSGM flow over a grid of devices: frame shards x row tiles, in one
process or with the frame shards over ranks (a RankMesh, as
parallel/tiled.py).

Counterpart of fsgm_tpu/parallel/tiled_flow.py (``flow_fsgm_sharded``),
on the tile lists of parallel/tiled.py.  A frame shard's frames go through
its chain of row tiles as one pass, ``chunk`` frames at a time (the
reference's vmap over a shard's frames): every tile holds an (N, Ht, W)
stack.  Per pyramid level, coarsest first, on each row tile:

    census (``halo`` true rows of each neighbour) -> K6 flow_cost in tiled
    mode (the full second images, the prior flow extended by ``radius``
    true rows of each neighbour) -> K2 x 8 with the 2D label rule, the
    vertical families carried across the seams
    (parallel/tiled.py::aggregate_tiled, "exact" or "fast") -> K4 and the
    parabola -> the median over one exchanged row.

The forward and backward passes of a level run in lockstep, as
models/flow.py::_fsgm_flow_both schedules them: where the backward pass
runs, a tile's level is one launch set over 2N slices (the first images
[t1; t2], the whole second images [t2; t1], the priors [forward;
backward]); below its last level the forward slices run alone.  The second
images are of the whole frame (the 2D search is vertically unbounded):
each device gathers the tiles' rows once and builds their pyramid and
each level's census once.  The first images' pyramid runs per tile, so H
must divide by tiles_y * 2^(levels-1).  The forward-backward check
gathers the backward field and checks each tile's rows in global rows,
over the N frames at once; every ``fb_backward`` mode runs as in
models/flow.py.  A shard of one row tile is flow_fsgm_batch itself.

One fault of the reference is refused instead of copied: it always checks
on the full grid, also under ``fb_grid="half"``; the port raises where
there are several row tiles.
"""

from __future__ import annotations

import dataclasses

import torch

from fsgm_tpu_torch.params import DIRS_8, DistParams, FlowParams
from fsgm_tpu_torch.models.flow import (_FRAME_BYTES_PER_LABEL_PIXEL,
                                        _free_bytes, _level_extract,
                                        _zero_flow, build_pyramid, fb_check,
                                        flow_fsgm_batch, upsample_flow_2x)
from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.kernels import aggregate as agg
from fsgm_tpu_torch.ops.kernels import extract, flow_cost
from fsgm_tpu_torch.parallel.multihost import RankMesh, run_rank_shards
from fsgm_tpu_torch.parallel.tiled import (aggregate_tiled, device_grid,
                                           exchange_row_halo, gather_rows,
                                           per_device, tile_margin)

# K4 walks at most this many rows N * H in one launch; a pass's level 0
# holds up to 2 * chunk slices of a tile's rows
MAX_ROWS = extract.MAX_ROWS
# Card memory a frame of a pass takes for the whole second images of a
# device: the gathered [t1; t2] rows (2 bytes a pixel), their swapped
# pyramid (at most 4/3 of that) and one level's int64 census of both
# (16), rounded up
_SECOND_BYTES_PER_PIXEL = 22


def _flow_level(i1: list, c2: list, prior: list, parts: list,
                dist: DistParams, counters: dict | None) -> list:
    """One pyramid level on a chain of row tiles over N slices: i1 the (N,
    Ht, W) tiles of the first images, c2 the census of the whole second
    images (N, H, W) on each tile's device, prior the (N, Ht, W, 2) prior
    flow tiles -> the level's (N, Ht, W, 2) flow tiles.  ``parts`` lists
    (params, slices) in slice order: the parts share one K6 and one tiled
    K2 a tile and extract each with its own params (the last backward
    level under fb_backward "cheap"); they differ only there."""
    params = parts[0][0]
    ht = i1[0].shape[-2]
    halo = max(params.census_window[0] // 2, 2)
    i1_ext = exchange_row_halo(i1, halo, counters)
    cen1 = [census_transform(x, params.census_window)[..., halo:-halo, :]
            .contiguous() for x in i1_ext]
    r, e, nl = params.search_radius, params.window_extent, params.num_labels
    prior_ext = exchange_row_halo(prior, r, counters, dim=-3)
    base_u = [torch.round(f[..., 0]).to(torch.int32) for f in prior_ext]
    base_v = [torch.round(f[..., 1]).to(torch.int32) for f in prior_ext]
    costs = [flow_cost.flow_cost(c1, c2k, bu, bv, r, params.invalid_cost,
                                 nl_pad=-(-nl // 32) * 32, y_offset=k * ht,
                                 census_bits=params.census_bits)
             for k, (c1, c2k, bu, bv) in enumerate(zip(cen1, c2, base_u,
                                                       base_v))]
    halos = [(x[..., halo - 2:halo, :], x[..., halo + ht:halo + ht + 2, :])
             for x in i1_ext]
    s = aggregate_tiled(costs, i1, halos, DIRS_8, params.p1, params.p2,
                        params.adaptive_p2, dist.tile_mode,
                        tile_margin(params, dist), counters,
                        agg.plan_dtypes(8 * (params.invalid_cost
                                             + params.p2)),
                        label_ext=e, nl=nl)
    del costs
    flows, lo = [], 0
    for p, m in parts:
        sl = slice(lo, lo + m)
        flow = [_level_extract(sk[sl], bu[sl, r:r + ht], bv[sl, r:r + ht],
                               dataclasses.replace(p, median_filter=False),
                               plain=False)
                for sk, bu, bv in zip(s, base_u, base_v)]
        if p.median_filter:
            flow = [torch.stack([ext.median_filter_3x3(f[..., 0]),
                                 ext.median_filter_3x3(f[..., 1])],
                                -1)[..., 1:-1, :, :]
                    for f in exchange_row_halo(flow, 1, counters, dim=-3)]
        flows.append(flow)
        lo += m
    return flows[0] if len(flows) == 1 else [torch.cat(f)
                                             for f in zip(*flows)]


def _flow_chain(t1: list, t2: list, params: FlowParams, dist: DistParams,
                counters: dict | None):
    """N frames on a chain of row tiles ((N, Ht, W) tiles, tile k on its
    own device) -> (flow tiles (N, Ht, W, 2), validity tiles (N, Ht, W)):
    models/flow.py::_flow over the tiles, both passes of a level in
    lockstep where the backward pass runs (levels >= bwd_stop: 0 for full
    and cheap, 1 for half), "single"'s one backward level after the
    forward pass."""
    n, ht = t1[0].shape[0], t1[0].shape[-2]
    levels, cw = params.levels, params.census_window
    mode = params.fb_backward if params.fb_check else None
    nosub = dataclasses.replace(params, subpixel=False, median_filter=False)
    bwd_stop = {"full": 0, "cheap": 0, "half": 1}.get(mode, levels)
    bwd_last = nosub if mode == "cheap" else params
    if mode is None:
        pyr1 = [build_pyramid(x, levels) for x in t1]
        pyr2 = per_device(lambda g: build_pyramid(g, levels),
                          gather_rows(t2, counters))
    else:
        # first images [t1; t2] a tile, second images [t2; t1] a device,
        # from one gather of the stacked tiles
        firsts = [torch.cat([a, b]) for a, b in zip(t1, t2)]
        pyr1 = [build_pyramid(x, levels) for x in firsts]
        pyr2 = per_device(lambda g: build_pyramid(
            torch.cat([g[n:], g[:n]]), levels), gather_rows(firsts, counters))
    # the priors [forward; backward] from the coarsest level on, split
    # where the backward pass ends (half: below level 1)
    stacked = mode in ("full", "cheap", "half")
    flow = [_zero_flow(p[-1][:2 * n if stacked else n]) for p in pyr1]
    bwd = None
    for lvl in range(levels - 1, -1, -1):
        m = 2 * n if lvl >= bwd_stop else n
        if flow[0].shape[0] > m:   # the backward pass ended a level above
            bwd, flow = [f[n:] for f in flow], [f[:n] for f in flow]
        i1 = [p[lvl][:m] for p in pyr1]
        if lvl < levels - 1:
            flow = [upsample_flow_2x(f, x.shape[-2], x.shape[-1])
                    for f, x in zip(flow, i1)]
        c2 = per_device(lambda x: census_transform(x[:m], cw),
                        [p[lvl] for p in pyr2])
        bp = bwd_last if lvl == bwd_stop else params
        parts = [(params, n), (bp, n)] if m > n and bp != params \
            else [(params, m)]
        flow = _flow_level(i1, c2, flow, parts, dist, counters)
    if mode is None:
        return flow, [torch.ones(f.shape[:-1], dtype=torch.bool,
                                 device=f.device) for f in flow]
    if mode == "single":
        c1 = per_device(lambda x: census_transform(x[n:], cw),
                        [p[0] for p in pyr2])
        bwd = _flow_level([p[0][n:] for p in pyr1], c1, [-f for f in flow],
                          [(nosub, n)], dist, counters)
    elif mode == "half":
        bwd = [upsample_flow_2x(b, f.shape[-3], f.shape[-2])
               for b, f in zip(bwd, flow)]
    else:
        flow, bwd = [f[:n] for f in flow], [f[n:] for f in flow]
    valid = [fb_check(f, b, params.fb_max_diff, y0=k * ht)
             for k, (f, b) in enumerate(zip(flow, gather_rows(
                 bwd, counters, dim=-3)))]
    return flow, valid


def flow_fsgm_sharded(imgs1: torch.Tensor, imgs2: torch.Tensor,
                      params: FlowParams, dist: DistParams, devices=None,
                      counters: dict | None = None,
                      chunk: int | None = None):
    """(F, H, W) uint8 pairs -> (flow (F, H, W, 2) float32, valid (F, H, W)
    bool), each frame bit-identical to flow_fsgm in "exact" mode.

    F is split into dist.frame_shards shards and rows into dist.tiles_y
    tiles: F must divide by frame_shards and, with several row tiles, H by
    tiles_y * 2^(levels-1); tiles_x must be 1.  A shard runs ``chunk``
    frames a pass, as flow_fsgm_batch does: None takes all of a shard's
    frames on the CPU and, on the card, as many as the free memory of its
    most loaded device holds; a chunk that does not divide the shard is
    rounded down to one that does.  With one row tile a shard is
    flow_fsgm_batch on the tile's device (any H, every fb_grid): no row
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
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if chunk is not None and 2 * min(chunk, f // fs) * (h // ty) > MAX_ROWS:
        raise ValueError(f"chunk {chunk}: a pass's 2 x chunk x {h // ty} "
                         f"tile rows exceed the {MAX_ROWS} rows K4 takes in "
                         f"one launch")
    if isinstance(devices, RankMesh):
        return run_rank_shards(
            devices, dist, lambda a, b, d, devs: _flow_frames(
                a, b, params, d, devs, counters, chunk), imgs1, imgs2)
    return _flow_frames(imgs1, imgs2, params, dist, devices, counters, chunk)


def _frames_a_pass(devs: list, fl: int, h: int, w: int,
                   params: FlowParams) -> int:
    """chunk=None for a shard of fl frames on the row tiles on ``devs``:
    all fl, or on the card as many as the free memory of the most loaded
    device holds (at least one).  A frame costs a device each of its
    tiles' level-0 label volume, Ht * W * num_labels at models/flow.py's
    bytes a label and pixel (the cost, S and their temporaries over both
    passes), and once the whole second images' (_SECOND_BYTES_PER_PIXEL
    a pixel of the frame); K4's row limit caps it too."""
    ht = h // len(devs)
    n = min(fl, MAX_ROWS // (2 * ht))
    for d in set(devs):
        free = _free_bytes(d)
        if free is not None:
            frame = (devs.count(d) * ht * w * params.num_labels
                     * _FRAME_BYTES_PER_LABEL_PIXEL
                     + h * w * _SECOND_BYTES_PER_PIXEL)
            n = min(n, free // frame)
    return max(1, n)


def _flow_frames(imgs1: torch.Tensor, imgs2: torch.Tensor,
                 params: FlowParams, dist: DistParams, devices,
                 counters: dict | None, chunk: int | None):
    f, h, w = imgs1.shape
    fs, ty = dist.frame_shards, dist.tiles_y
    grid = device_grid(devices, (fs, ty), imgs1.device)
    fl, ht = f // fs, h // ty
    flows = torch.empty((f, h, w, 2), dtype=torch.float32,
                        device=imgs1.device)
    valids = torch.empty((f, h, w), dtype=torch.bool, device=imgs1.device)
    for a, devs in enumerate(grid):
        shard = slice(a * fl, (a + 1) * fl)
        if ty == 1:
            flow, valid = flow_fsgm_batch(imgs1[shard].to(devs[0]),
                                          imgs2[shard].to(devs[0]), params,
                                          chunk)
            flows[shard], valids[shard] = flow.to(flows.device), \
                valid.to(valids.device)
            continue
        step = (_frames_a_pass(devs, fl, h, w, params) if chunk is None
                else min(chunk, fl))
        while fl % step:
            step -= 1
        for k in range(a * fl, (a + 1) * fl, step):
            t1, t2 = ([img[k:k + step, y * ht:(y + 1) * ht].to(devs[y])
                       .contiguous() for y in range(ty)]
                      for img in (imgs1, imgs2))
            flow, valid = _flow_chain(t1, t2, params, dist, counters)
            for y in range(ty):
                flows[k:k + step, y * ht:(y + 1) * ht] = \
                    flow[y].to(flows.device)
                valids[k:k + step, y * ht:(y + 1) * ht] = \
                    valid[y].to(valids.device)
    return flows, valids
