"""fSGM optical flow in PyTorch: hierarchical coarse-to-fine 2D-label SGM.

Counterpart of fsgm_tpu/models/flow.py (``flow_fsgm``, ``flow_fsgm_batch``,
``flow_sequence``).  Per pyramid level, coarsest first:

    census (plain torch) -> label-major flow cost (plain torch, ops/cost.py)
    -> K5 label_minor_from_major -> K2 over 8 directions with the 2D
    label rule (aggregate_paths: on one H100 every level of a KITTI frame
    takes two family launches) -> K4 extract_flow -> parabola, base + offset and median (plain
    torch)

over the (2w+1)^2 label window centred on the 2x-upsampled coarser flow.
The label axis is padded to a multiple of 32 for the kernels; the padding
takes part in nothing (ops/kernels/aggregate.py).  The forward-backward
check, its backward-pass modes (``fb_backward`` full / cheap / single /
half) and grids (``fb_grid`` full / half), and the temporal prior follow
the JAX package exactly; the forward and backward passes of a level run one
after the other.

The device is the inputs' device: CUDA tensors launch the kernels, CPU
tensors run their plain versions.  ``flow_fsgm_reference`` composes only
the plain versions (label-minor cost, no padding), on any device, as the
end-to-end check of the kernels.  Flow values are float32.
"""

from __future__ import annotations

import dataclasses

import torch

from fsgm_tpu_torch.params import DIRS_8, FlowParams
from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.cost import cost_volume_flow, cost_volume_flow_major
from fsgm_tpu_torch.ops.kernels import aggregate, extract, transpose


# --------------------------------------------------------------------------
# Integer-exact pyramid and flow resampling
# --------------------------------------------------------------------------

def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample, round-half-up: (a+b+c+d+2)//4; floor dims."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    s = img[:2 * h2, :2 * w2].to(torch.int32).reshape(h2, 2, w2, 2)
    return ((s.sum(dim=(1, 3)) + 2) // 4).to(img.dtype)


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """[level 0 (full resolution), level 1, ...]: ``levels`` images."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2x(pyr[-1]))
    return pyr


def _nearest_2x(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """x[i // 2, j // 2] over (out_h, out_w), the last row / column repeated
    past 2x the input (odd finer levels)."""
    dev = x.device
    rows = (torch.arange(out_h, device=dev) // 2).clamp_(max=x.shape[0] - 1)
    cols = (torch.arange(out_w, device=dev) // 2).clamp_(max=x.shape[1] - 1)
    return x.index_select(0, rows).index_select(1, cols)


def upsample_flow_2x(flow: torch.Tensor, out_h: int, out_w: int
                     ) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of (H, W, 2), values x2, edge-extended
    to (out_h, out_w)."""
    return _nearest_2x(flow, out_h, out_w) * 2.0


def upsample_valid_2x(valid: torch.Tensor, out_h: int, out_w: int
                      ) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of a bool validity plane (the
    fb_grid='half' merge), edge-extended to (out_h, out_w)."""
    return _nearest_2x(valid, out_h, out_w)


def downsample_flow_2x(flow: torch.Tensor) -> torch.Tensor:
    """2x2 box mean of (H, W, 2), values / 2; floor dims.  Summed in the
    order ((a+b)+c)+d: another order can differ in the last ulp and flip a
    rounded window centre."""
    h2, w2 = flow.shape[0] // 2, flow.shape[1] // 2
    x = flow[:2 * h2, :2 * w2].reshape(h2, 2, w2, 2, flow.shape[2])
    a, b = x[:, 0, :, 0], x[:, 0, :, 1]
    c, d = x[:, 1, :, 0], x[:, 1, :, 1]
    return (a + b + c + d) * 0.125


# --------------------------------------------------------------------------
# Extraction tail and forward-backward check
# --------------------------------------------------------------------------

def _parabola(idx, v_m, v_0, v_p, size: int) -> torch.Tensor:
    """Offset from a 3-point parabola fit in float32, gated on an interior
    index and a positive curvature."""
    v_m, v_0, v_p = (v.to(torch.float32) for v in (v_m, v_0, v_p))
    interior = (idx > 0) & (idx < size - 1)
    denom = v_m - 2.0 * v_0 + v_p
    ok = interior & (denom > 0)
    off = torch.where(ok, (v_m - v_p) / torch.clamp(2.0 * denom, min=1e-12),
                      0.0)
    return off.clamp(-0.5, 0.5) * ok


def fb_check(flow_fwd: torch.Tensor, flow_bwd: torch.Tensor,
             max_diff: float, y0: int = 0) -> torch.Tensor:
    """(H, W) bool: |F(p) + B(p + round(F(p)))| <= max_diff, the lookup
    inside the image (round half to even).  An explicit validity plane:
    no flow value is overwritten.  A row tile (parallel/tiled_flow.py)
    passes its first global row y0 and the whole backward field."""
    h, w = flow_fwd.shape[:2]
    hg = flow_bwd.shape[0]
    dev = flow_fwd.device
    yy = torch.arange(h, device=dev, dtype=torch.int32)[:, None] + y0
    xx = torch.arange(w, device=dev, dtype=torch.int32)[None, :]
    tx = xx + torch.round(flow_fwd[..., 0]).to(torch.int32)
    ty = yy + torch.round(flow_fwd[..., 1]).to(torch.int32)
    inb = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < hg)
    src = ty.clamp(0, hg - 1).to(torch.int64) * w + tx.clamp(0, w - 1)
    b = flow_bwd.reshape(hg * w, 2)[src]
    err = torch.sqrt((flow_fwd[..., 0] + b[..., 0]) ** 2
                     + (flow_fwd[..., 1] + b[..., 1]) ** 2)
    return inb & (err <= max_diff)


# --------------------------------------------------------------------------
# Per-level core and pyramid driver
# --------------------------------------------------------------------------

def _level_s(img1, cen1, cen2, base_u, base_v, params: FlowParams,
             plain: bool) -> torch.Tensor:
    """Cost volume + 8-path 2D-label aggregation of one level: (H, W, D)
    S, D = nl (plain) or nl padded to a multiple of 32 (kernels)."""
    e, r = params.window_extent, params.search_radius
    nl = params.num_labels
    s_max = 8 * (params.invalid_cost + params.p2)
    if plain:
        cost = cost_volume_flow(cen1, cen2, base_u, base_v, r,
                                params.invalid_cost)
        return aggregate.aggregate_paths_plain(
            cost, img1, DIRS_8, params.p1, params.p2, params.adaptive_p2,
            s_max=s_max, label_ext=e)
    cost_m = cost_volume_flow_major(cen1, cen2, base_u, base_v, r,
                                    params.invalid_cost,
                                    nl_pad=-(-nl // 32) * 32)
    cost = transpose.label_minor_from_major(cost_m)
    return aggregate.aggregate_paths(
        cost, img1, DIRS_8, params.p1, params.p2, params.adaptive_p2,
        s_max=s_max, label_ext=e, nl=nl)


def _level_extract(s, base_u, base_v, params: FlowParams,
                   plain: bool) -> torch.Tensor:
    """WTA + optional subpixel refinement and median on one level's S."""
    e, r = params.window_extent, params.search_radius
    extract_flow = extract.extract_flow_plain if plain \
        else extract.extract_flow
    l_int, ut, vt = extract_flow(s, params.num_labels, e, params.subpixel)
    iv = l_int // e
    iu = l_int - iv * e
    u = (base_u + (iu - r)).to(torch.float32)
    v = (base_v + (iv - r)).to(torch.float32)
    if params.subpixel:
        u = u + _parabola(iu, *ut, e)
        v = v + _parabola(iv, *vt, e)
    if params.median_filter:
        u, v = ext.median_filter_3x3(u), ext.median_filter_3x3(v)
    return torch.stack([u, v], dim=-1)


def _flow_one_level(img1, cen1, cen2, prior_flow, params: FlowParams,
                    plain: bool) -> torch.Tensor:
    base_u = torch.round(prior_flow[..., 0]).to(torch.int32)
    base_v = torch.round(prior_flow[..., 1]).to(torch.int32)
    s = _level_s(img1, cen1, cen2, base_u, base_v, params, plain)
    return _level_extract(s, base_u, base_v, params, plain)


def _zero_flow(img: torch.Tensor) -> torch.Tensor:
    return torch.zeros(img.shape + (2,), dtype=torch.float32,
                       device=img.device)


def _fsgm_flow_oneway(pyr1, pyr2, cens1, cens2, params: FlowParams,
                      plain: bool, init_flow=None) -> torch.Tensor:
    """Coarse-to-fine pass over precomputed pyramids and census
    descriptors; ``init_flow`` (coarsest scale) seeds it instead of zeros."""
    flow = _zero_flow(pyr1[-1]) if init_flow is None else init_flow
    for lvl in range(params.levels - 1, -1, -1):
        i1 = pyr1[lvl]
        if lvl < params.levels - 1:
            flow = upsample_flow_2x(flow, i1.shape[0], i1.shape[1])
        flow = _flow_one_level(i1, cens1[lvl], cens2[lvl], flow, params,
                               plain)
    return flow


def _fsgm_flow_both(pyr1, pyr2, cens1, cens2, params: FlowParams,
                    bwd_final_params: FlowParams, bwd_stop: int,
                    plain: bool, init_flow=None):
    """Forward and backward coarse-to-fine passes, level by level.  The
    backward pass runs at levels >= bwd_stop (0 for full/cheap, 1 for
    half) with the roles of the images swapped; levels above its last one
    extract with the full ``params`` (their output is the next level's
    prior), its last level with ``bwd_final_params``.

    Returns (forward flow at full resolution, backward flow at level
    bwd_stop's resolution)."""
    if init_flow is None:
        flow_f, flow_b = _zero_flow(pyr1[-1]), _zero_flow(pyr1[-1])
    else:
        flow_f, flow_b = init_flow, -init_flow
    for lvl in range(params.levels - 1, -1, -1):
        i1, i2 = pyr1[lvl], pyr2[lvl]
        if lvl < params.levels - 1:
            flow_f = upsample_flow_2x(flow_f, i1.shape[0], i1.shape[1])
            if lvl >= bwd_stop:
                flow_b = upsample_flow_2x(flow_b, i1.shape[0], i1.shape[1])
        flow_f = _flow_one_level(i1, cens1[lvl], cens2[lvl], flow_f, params,
                                 plain)
        if lvl >= bwd_stop:
            bp = bwd_final_params if lvl == bwd_stop else params
            flow_b = _flow_one_level(i2, cens2[lvl], cens1[lvl], flow_b, bp,
                                     plain)
    return flow_f, flow_b


def _check(img1: torch.Tensor, img2: torch.Tensor, prior_flow) -> None:
    if img1.shape != img2.shape or img1.dim() != 2:
        raise ValueError(f"image shapes {tuple(img1.shape)} and "
                         f"{tuple(img2.shape)} must be equal (H, W)")
    if img1.device != img2.device:
        raise ValueError("images lie on different devices")
    if prior_flow is not None and (
            tuple(prior_flow.shape) != tuple(img1.shape) + (2,)
            or prior_flow.device != img1.device):
        raise ValueError(f"prior_flow {tuple(prior_flow.shape)} on "
                         f"{prior_flow.device} must be (H, W, 2) on the "
                         f"images' device {img1.device}")


def _flow(img1: torch.Tensor, img2: torch.Tensor, params: FlowParams,
          prior_flow, plain: bool):
    """The port of fsgm_tpu/models/flow.py::_flow_fsgm_jit."""
    _check(img1, img2, prior_flow)
    pyr1 = build_pyramid(img1, params.levels)
    pyr2 = build_pyramid(img2, params.levels)
    cens1 = [census_transform(x, params.census_window) for x in pyr1]
    cens2 = [census_transform(x, params.census_window) for x in pyr2]
    init = None
    if prior_flow is not None:
        init = prior_flow.to(torch.float32)
        for _ in range(params.levels - 1):
            init = downsample_flow_2x(init)
    if not params.fb_check:
        flow = _fsgm_flow_oneway(pyr1, pyr2, cens1, cens2, params, plain,
                                 init)
        return flow, torch.ones(flow.shape[:2], dtype=torch.bool,
                                device=flow.device)
    if params.fb_backward == "single":
        # one backward level at full resolution, prior = -forward flow,
        # no subpixel or median
        flow = _fsgm_flow_oneway(pyr1, pyr2, cens1, cens2, params, plain,
                                 init)
        bwd_params = dataclasses.replace(params, subpixel=False,
                                         median_filter=False)
        flow_bwd = _flow_one_level(pyr2[0], cens2[0], cens1[0], -flow,
                                   bwd_params, plain)
    elif params.fb_backward == "half":
        # the backward pyramid stops at level 1 (half resolution)
        flow, bwd_half = _fsgm_flow_both(pyr1, pyr2, cens1, cens2, params,
                                         params, 1, plain, init)
        if params.fb_grid == "half":
            valid_h = fb_check(downsample_flow_2x(flow), bwd_half,
                               params.fb_max_diff * 0.5)
            return flow, upsample_valid_2x(valid_h, flow.shape[0],
                                           flow.shape[1])
        flow_bwd = upsample_flow_2x(bwd_half, flow.shape[0], flow.shape[1])
    else:
        bwd_final = params
        if params.fb_backward == "cheap":
            bwd_final = dataclasses.replace(params, subpixel=False,
                                            median_filter=False)
        flow, flow_bwd = _fsgm_flow_both(pyr1, pyr2, cens1, cens2, params,
                                         bwd_final, 0, plain, init)
    if params.fb_grid == "half":
        valid_h = fb_check(downsample_flow_2x(flow),
                           downsample_flow_2x(flow_bwd),
                           params.fb_max_diff * 0.5)
        return flow, upsample_valid_2x(valid_h, flow.shape[0], flow.shape[1])
    return flow, fb_check(flow, flow_bwd, params.fb_max_diff)


def flow_fsgm(img1: torch.Tensor, img2: torch.Tensor, params: FlowParams,
              prior_flow: torch.Tensor | None = None):
    """(H, W) uint8 pair -> (flow (H, W, 2) float32, valid (H, W) bool).

    ``valid`` is False where the forward-backward check failed (flow there
    holds the unchecked forward estimate).  ``prior_flow``, a
    full-resolution (H, W, 2) field, seeds the coarsest level (its
    negation the backward pass): the temporal prior of flow_sequence."""
    return _flow(img1, img2, params, prior_flow, plain=False)


def flow_fsgm_reference(img1: torch.Tensor, img2: torch.Tensor,
                        params: FlowParams,
                        prior_flow: torch.Tensor | None = None):
    """flow_fsgm through the plain PyTorch versions only."""
    return _flow(img1, img2, params, prior_flow, plain=True)


def flow_fsgm_batch(imgs1: torch.Tensor, imgs2: torch.Tensor,
                    params: FlowParams):
    """(B, H, W) uint8 pairs -> (flows (B, H, W, 2), valids (B, H, W)):
    each frame through the same kernels, one after another."""
    if imgs1.dim() != 3 or imgs1.shape != imgs2.shape:
        raise ValueError(f"batch shapes {tuple(imgs1.shape)} and "
                         f"{tuple(imgs2.shape)} must be equal (B, H, W)")
    flows, valids = zip(*[flow_fsgm(a, b, params)
                          for a, b in zip(imgs1, imgs2)])
    return torch.stack(flows), torch.stack(valids)


def flow_sequence(frames: torch.Tensor, params: FlowParams,
                  track_params: FlowParams | None = None):
    """fSGM over (N, H, W) uint8 frames with temporal priors ->
    (flows (N-1, H, W, 2), valids (N-1, H, W)), flows[t] = motion from
    frame t to t+1.  Pair 0 runs ``params`` from scratch; every later pair
    runs ``track_params`` (default ``params``) seeded with the previous
    pair's field where it passed the forward-backward check."""
    tp = track_params if track_params is not None else params
    flows, valids = [], []
    prev = None
    for t in range(frames.shape[0] - 1):
        f, v = flow_fsgm(frames[t], frames[t + 1],
                         params if prev is None else tp, prior_flow=prev)
        flows.append(f)
        valids.append(v)
        prev = torch.where(v[..., None], f, 0.0)
    return torch.stack(flows), torch.stack(valids)
