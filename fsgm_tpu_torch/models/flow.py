"""fSGM optical flow in PyTorch: hierarchical coarse-to-fine 2D-label SGM.

Counterpart of fsgm_tpu/models/flow.py (``flow_fsgm``, ``flow_fsgm_batch``,
``flow_sequence``).  Per pyramid level, coarsest first:

    census (plain torch) -> label-major flow cost (plain torch, ops/cost.py)
    -> K5 label_minor_from_major -> K2 over 8 directions with the 2D
    label rule (aggregate_paths, which plans its launches from the slice
    count) -> K4 extract_flow -> parabola, base + offset and median (plain
    torch)

over the (2w+1)^2 label window centred on the 2x-upsampled coarser flow.
The label axis is padded to a multiple of 32 for the kernels; the padding
takes part in nothing (ops/kernels/aggregate.py).  The forward-backward
check, its backward-pass modes (``fb_backward`` full / cheap / single /
half) and grids (``fb_grid`` full / half), and the temporal prior follow
the JAX package exactly.

Every level runs over a leading slice axis, as the reference's vmaps do
(``_flow_level_pair``, ``_flow_fsgm_batch_jit``): a call takes B frames,
and at each level where the backward pass runs, its B slices join the
forward pass's B (the guides, census pairs and window bases of both
directions stacked), so that level is one cost build, one K5, one K2 plan
and one K4 over 2B slices.  Below the backward pass's last level the
forward slices run alone.  ``flow_fsgm`` is the batch of one;
``flow_fsgm_batch`` takes ``chunk`` frames a pass (by default all, or on
the card as many as its free memory holds).

The device is the inputs' device: CUDA tensors launch the kernels, CPU
tensors run their plain versions.  ``flow_fsgm_reference`` composes only
the plain versions (label-minor cost, no padding) frame by frame, the two
directions of a level one after the other, on any device, as the
end-to-end check of the kernels and of the slice stacking.  Flow values
are float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from fsgm_tpu_torch.params import DIRS_8, FlowParams
from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.cost import cost_volume_flow, cost_volume_flow_major
from fsgm_tpu_torch.ops.kernels import aggregate, extract, transpose
from fsgm_tpu_torch.utils import tracing


# --------------------------------------------------------------------------
# Integer-exact pyramid and flow resampling, over any leading axes
# --------------------------------------------------------------------------

def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample of (..., H, W), round-half-up: (a+b+c+d+2)//4;
    floor dims."""
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    s = img[..., :2 * h2, :2 * w2].to(torch.int32).reshape(
        img.shape[:-2] + (h2, 2, w2, 2))
    return ((s.sum(dim=(-3, -1)) + 2) // 4).to(img.dtype)


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """[level 0 (full resolution), level 1, ...]: ``levels`` images of
    (..., H, W)."""
    pyr = [img]
    with tracing.span("fsgm.pyramid"):
        for _ in range(levels - 1):
            pyr.append(downsample2x(pyr[-1]))
    return pyr


def _nearest_2x(x: torch.Tensor, out_h: int, out_w: int,
                row_dim: int) -> torch.Tensor:
    """x[..., i // 2, j // 2, ...] over (out_h, out_w) at axes (row_dim,
    row_dim + 1), the last row / column repeated past 2x the input (odd
    finer levels)."""
    dev = x.device
    rows = (torch.arange(out_h, device=dev) // 2).clamp_(
        max=x.shape[row_dim] - 1)
    cols = (torch.arange(out_w, device=dev) // 2).clamp_(
        max=x.shape[row_dim + 1] - 1)
    return x.index_select(row_dim, rows).index_select(row_dim + 1, cols)


def upsample_flow_2x(flow: torch.Tensor, out_h: int, out_w: int
                     ) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of (..., H, W, 2), values x2,
    edge-extended to (out_h, out_w)."""
    return _nearest_2x(flow, out_h, out_w, -3) * 2.0


def upsample_valid_2x(valid: torch.Tensor, out_h: int, out_w: int
                      ) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of a bool validity plane (..., H, W)
    (the fb_grid='half' merge), edge-extended to (out_h, out_w)."""
    return _nearest_2x(valid, out_h, out_w, -2)


def downsample_flow_2x(flow: torch.Tensor) -> torch.Tensor:
    """2x2 box mean of (..., H, W, 2), values / 2; floor dims.  Summed in
    the order ((a+b)+c)+d: another order can differ in the last ulp and
    flip a rounded window centre."""
    h2, w2 = flow.shape[-3] // 2, flow.shape[-2] // 2
    x = flow[..., :2 * h2, :2 * w2, :].reshape(
        flow.shape[:-3] + (h2, 2, w2, 2, flow.shape[-1]))
    a, b = x[..., :, 0, :, 0, :], x[..., :, 0, :, 1, :]
    c, d = x[..., :, 1, :, 0, :], x[..., :, 1, :, 1, :]
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
    """(..., H, W) bool: |F(p) + B(p + round(F(p)))| <= max_diff, the
    lookup inside the image (round half to even), each slice of the leading
    axes in its own backward field.  An explicit validity plane: no flow
    value is overwritten.  A row tile (parallel/tiled_flow.py) passes its
    first global row y0 and the whole backward field."""
    h, w = flow_fwd.shape[-3:-1]
    hg = flow_bwd.shape[-3]
    lead = flow_fwd.shape[:-3]
    dev = flow_fwd.device
    yy = torch.arange(h, device=dev, dtype=torch.int32)[:, None] + y0
    xx = torch.arange(w, device=dev, dtype=torch.int32)[None, :]
    tx = xx + torch.round(flow_fwd[..., 0]).to(torch.int32)
    ty = yy + torch.round(flow_fwd[..., 1]).to(torch.int32)
    inb = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < hg)
    frame = torch.arange(math.prod(lead), device=dev,
                         dtype=torch.int64).view(lead + (1, 1)) * (hg * w)
    src = frame + ty.clamp(0, hg - 1).to(torch.int64) * w \
        + tx.clamp(0, w - 1)
    b = flow_bwd.reshape(-1, 2)[src]
    err = torch.sqrt((flow_fwd[..., 0] + b[..., 0]) ** 2
                     + (flow_fwd[..., 1] + b[..., 1]) ** 2)
    return inb & (err <= max_diff)


# --------------------------------------------------------------------------
# Per-level core over N slices, and the pyramid pass over B frames
# --------------------------------------------------------------------------

def _level_s(img1, cen1, cen2, base_u, base_v, params: FlowParams,
             plain: bool) -> torch.Tensor:
    """Cost volume + 8-path 2D-label aggregation of one level over N
    slices ((N, H, W) guides, census and bases): (N, H, W, D) S, D = nl
    (plain) or nl padded to a multiple of 32 (kernels: one K5, one K2 plan
    over the N slices)."""
    e, r = params.window_extent, params.search_radius
    nl = params.num_labels
    s_max = 8 * (params.invalid_cost + params.p2)
    if plain:
        with tracing.span("fsgm.cost"):
            cost = cost_volume_flow(cen1, cen2, base_u, base_v, r,
                                    params.invalid_cost)
        return aggregate.aggregate_paths_plain(
            cost, img1, DIRS_8, params.p1, params.p2, params.adaptive_p2,
            s_max=s_max, label_ext=e)
    with tracing.span("fsgm.cost"):
        cost_m = cost_volume_flow_major(cen1, cen2, base_u, base_v, r,
                                        params.invalid_cost,
                                        nl_pad=-(-nl // 32) * 32)
    with tracing.span("fsgm.transpose"):
        cost = transpose.label_minor_from_major(cost_m)
    return aggregate.aggregate_paths(
        cost, img1, DIRS_8, params.p1, params.p2, params.adaptive_p2,
        s_max=s_max, label_ext=e, nl=nl)


def _level_extract(s, base_u, base_v, params: FlowParams,
                   plain: bool) -> torch.Tensor:
    """WTA + optional subpixel refinement and median on one level's S
    ((..., H, W, D); one K4 over all of it) -> (..., H, W, 2) flow."""
    e, r = params.window_extent, params.search_radius
    extract_flow = extract.extract_flow_plain if plain \
        else extract.extract_flow
    with tracing.span("fsgm.extract"):
        l_int, ut, vt = extract_flow(s, params.num_labels, e,
                                     params.subpixel)
    with tracing.span("fsgm.tail"):
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


def _bases(prior_flow: torch.Tensor):
    """The rounded window centres (base_u, base_v) of a prior flow."""
    return (torch.round(prior_flow[..., 0]).to(torch.int32),
            torch.round(prior_flow[..., 1]).to(torch.int32))


def _flow_one_level(img1, cen1, cen2, prior_flow, params: FlowParams,
                    plain: bool) -> torch.Tensor:
    """One level of one direction over N slices -> (N, H, W, 2)."""
    base_u, base_v = _bases(prior_flow)
    s = _level_s(img1, cen1, cen2, base_u, base_v, params, plain)
    return _level_extract(s, base_u, base_v, params, plain)


def _flow_level_pair(i1, i2, c1, c2, prior_f, prior_b, params: FlowParams,
                     bwd_params: FlowParams):
    """One pyramid level of the forward AND backward passes over B frames
    as one launch set over 2B slices (the JAX package's _flow_level_pair
    under its frame vmap): the forward slices [i1, c1 vs c2, prior_f]
    stacked on the backward ones [i2, c2 vs c1, prior_b], one cost build,
    K5, K2 plan and K4 over them.  Extraction runs over both halves at
    once where bwd_params equals params, else each half with its own
    params (the last backward level under fb_backward="cheap").  Per-slice
    arithmetic is that of two _flow_one_level calls on the kernel path."""
    b = i1.shape[0]
    base_u, base_v = _bases(torch.cat([prior_f, prior_b]))
    s = _level_s(torch.cat([i1, i2]), torch.cat([c1, c2]),
                 torch.cat([c2, c1]), base_u, base_v, params, plain=False)
    if bwd_params == params:
        flow = _level_extract(s, base_u, base_v, params, plain=False)
        return flow[:b], flow[b:]
    return (_level_extract(s[:b], base_u[:b], base_v[:b], params, False),
            _level_extract(s[b:], base_u[b:], base_v[b:], bwd_params, False))


def _zero_flow(img: torch.Tensor) -> torch.Tensor:
    return torch.zeros(img.shape + (2,), dtype=torch.float32,
                       device=img.device)


def _fsgm_flow_oneway(pyr1, cens1, cens2, params: FlowParams, plain: bool,
                      init_flow=None) -> torch.Tensor:
    """Coarse-to-fine pass over precomputed (B, h, w) pyramids and census
    descriptors; ``init_flow`` (coarsest scale) seeds it instead of
    zeros."""
    flow = _zero_flow(pyr1[-1]) if init_flow is None else init_flow
    for lvl in range(params.levels - 1, -1, -1):
        i1 = pyr1[lvl]
        with tracing.span("fsgm.level", level=lvl, slices=i1.shape[0]):
            if lvl < params.levels - 1:
                with tracing.span("fsgm.pyramid"):
                    flow = upsample_flow_2x(flow, i1.shape[-2], i1.shape[-1])
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
    prior), its last level with ``bwd_final_params``.  The kernel path
    runs both passes of such a level in lockstep (_flow_level_pair); the
    plain path (``plain``, the reference) one after the other.

    Returns (forward flow at full resolution, backward flow at level
    bwd_stop's resolution)."""
    if init_flow is None:
        flow_f, flow_b = _zero_flow(pyr1[-1]), _zero_flow(pyr1[-1])
    else:
        flow_f, flow_b = init_flow, -init_flow
    for lvl in range(params.levels - 1, -1, -1):
        i1, i2 = pyr1[lvl], pyr2[lvl]
        c1, c2 = cens1[lvl], cens2[lvl]
        h, w = i1.shape[-2:]
        with tracing.span("fsgm.level", level=lvl,
                          slices=i1.shape[0] * (1 + (lvl >= bwd_stop))):
            if lvl < params.levels - 1:
                with tracing.span("fsgm.pyramid"):
                    flow_f = upsample_flow_2x(flow_f, h, w)
                    if lvl >= bwd_stop:
                        flow_b = upsample_flow_2x(flow_b, h, w)
            if lvl < bwd_stop:
                flow_f = _flow_one_level(i1, c1, c2, flow_f, params, plain)
                continue
            bp = bwd_final_params if lvl == bwd_stop else params
            if plain:
                flow_f = _flow_one_level(i1, c1, c2, flow_f, params, plain)
                flow_b = _flow_one_level(i2, c2, c1, flow_b, bp, plain)
            else:
                flow_f, flow_b = _flow_level_pair(i1, i2, c1, c2, flow_f,
                                                  flow_b, params, bp)
    return flow_f, flow_b


def _check(imgs1: torch.Tensor, imgs2: torch.Tensor, prior_flow,
           batched: bool) -> None:
    dims = "(B, H, W), B >= 1" if batched else "(H, W)"
    if imgs1.shape != imgs2.shape or imgs1.dim() != 2 + batched \
            or (batched and imgs1.shape[0] == 0):
        raise ValueError(f"image shapes {tuple(imgs1.shape)} and "
                         f"{tuple(imgs2.shape)} must be equal {dims}")
    if imgs1.device != imgs2.device:
        raise ValueError("images lie on different devices")
    if prior_flow is not None and (
            tuple(prior_flow.shape) != tuple(imgs1.shape) + (2,)
            or prior_flow.device != imgs1.device):
        raise ValueError(f"prior_flow {tuple(prior_flow.shape)} on "
                         f"{prior_flow.device} must be (H, W, 2) on the "
                         f"images' device {imgs1.device}")


def _flow(imgs1: torch.Tensor, imgs2: torch.Tensor, params: FlowParams,
          prior_flow, plain: bool):
    """The port of fsgm_tpu/models/flow.py::_flow_fsgm_jit over (B, H, W)
    frames (its vmap in _flow_fsgm_batch_jit) -> ((B, H, W, 2) flow,
    (B, H, W) validity)."""
    pyr1 = build_pyramid(imgs1, params.levels)
    pyr2 = build_pyramid(imgs2, params.levels)
    cens1 = [census_transform(x, params.census_window) for x in pyr1]
    cens2 = [census_transform(x, params.census_window) for x in pyr2]
    init = None
    if prior_flow is not None:
        with tracing.span("fsgm.pyramid"):
            init = prior_flow.to(torch.float32)
            for _ in range(params.levels - 1):
                init = downsample_flow_2x(init)
    if not params.fb_check:
        flow = _fsgm_flow_oneway(pyr1, cens1, cens2, params, plain, init)
        return flow, torch.ones(flow.shape[:-1], dtype=torch.bool,
                                device=flow.device)
    bwd_half = params.fb_backward == "half"
    if params.fb_backward == "single":
        # one backward level at full resolution over the B frames, prior =
        # -forward flow, no subpixel or median
        flow = _fsgm_flow_oneway(pyr1, cens1, cens2, params, plain, init)
        bwd_params = dataclasses.replace(params, subpixel=False,
                                         median_filter=False)
        with tracing.span("fsgm.level", level=0, slices=flow.shape[0]):
            flow_bwd = _flow_one_level(pyr2[0], cens2[0], cens1[0], -flow,
                                       bwd_params, plain)
    elif bwd_half:
        # the backward pyramid stops at level 1 (half resolution)
        flow, flow_bwd = _fsgm_flow_both(pyr1, pyr2, cens1, cens2, params,
                                         params, 1, plain, init)
    else:
        bwd_final = params
        if params.fb_backward == "cheap":
            bwd_final = dataclasses.replace(params, subpixel=False,
                                            median_filter=False)
        flow, flow_bwd = _fsgm_flow_both(pyr1, pyr2, cens1, cens2, params,
                                         bwd_final, 0, plain, init)
    with tracing.span("fsgm.fb_check"):
        return flow, _fb_valid(flow, flow_bwd, bwd_half, params)


def _fb_valid(flow, flow_bwd, bwd_half: bool, params: FlowParams):
    """The forward-backward check of (B, H, W, 2) flow against the backward
    field (at half resolution where ``bwd_half``) on params.fb_grid."""
    h, w = flow.shape[-3:-1]
    if params.fb_grid == "half":
        bwd_h = flow_bwd if bwd_half else downsample_flow_2x(flow_bwd)
        valid_h = fb_check(downsample_flow_2x(flow), bwd_h,
                           params.fb_max_diff * 0.5)
        return upsample_valid_2x(valid_h, h, w)
    if bwd_half:
        flow_bwd = upsample_flow_2x(flow_bwd, h, w)
    return fb_check(flow, flow_bwd, params.fb_max_diff)


def _one_frame(img1, img2, params: FlowParams, prior_flow, plain: bool):
    _check(img1, img2, prior_flow, batched=False)
    with tracing.span("fsgm.flow", frames=1):
        flow, valid = _flow(img1[None], img2[None], params,
                            None if prior_flow is None else prior_flow[None],
                            plain)
    return flow[0], valid[0]


def flow_fsgm(img1: torch.Tensor, img2: torch.Tensor, params: FlowParams,
              prior_flow: torch.Tensor | None = None):
    """(H, W) uint8 pair -> (flow (H, W, 2) float32, valid (H, W) bool): the
    batch of one, each level's forward and backward passes in lockstep.

    ``valid`` is False where the forward-backward check failed (flow there
    holds the unchecked forward estimate).  ``prior_flow``, a
    full-resolution (H, W, 2) field, seeds the coarsest level (its
    negation the backward pass): the temporal prior of flow_sequence."""
    return _one_frame(img1, img2, params, prior_flow, plain=False)


def flow_fsgm_reference(img1: torch.Tensor, img2: torch.Tensor,
                        params: FlowParams,
                        prior_flow: torch.Tensor | None = None):
    """flow_fsgm through the plain PyTorch versions only, one frame, the
    forward and backward passes of a level one after the other."""
    return _one_frame(img1, img2, params, prior_flow, plain=True)


# Card memory one frame of a pass takes, a label and pixel of level 0: the
# port's bench flow cell (config 4, B = 8) peaks at about 42 on an H100
# (PERF.md section 5), doubled for the modes whose backward pass reaches
# level 0.
_FRAME_BYTES_PER_LABEL_PIXEL = 96


def _free_bytes(device: torch.device) -> int | None:
    """Bytes a pass may still take on ``device``: the card's free memory
    and what PyTorch's allocator holds unused (None on the CPU)."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def _frames_a_pass(imgs1: torch.Tensor, params: FlowParams) -> int:
    """flow_fsgm_batch's chunk=None: all B frames, or on the card as many
    as its free memory holds (at least one), so that a request's frame
    count does not bound what it may ask."""
    b, h, w = imgs1.shape
    free = _free_bytes(imgs1.device)
    if free is None:
        return b
    frame = h * w * params.num_labels * _FRAME_BYTES_PER_LABEL_PIXEL
    return max(1, min(b, free // frame))


def flow_fsgm_batch(imgs1: torch.Tensor, imgs2: torch.Tensor,
                    params: FlowParams, chunk: int | None = None):
    """(B, H, W) uint8 pairs -> (flows (B, H, W, 2), valids (B, H, W)),
    ``chunk`` frames a pass, each pass one launch set a level over its
    frames (both directions where the backward pass runs).  None: all B
    frames in one pass, or on the card as many as its free memory holds.
    A chunk that does not divide B is rounded down to one that does, as
    in the JAX package; each frame equals flow_fsgm's."""
    _check(imgs1, imgs2, None, batched=True)
    b = imgs1.shape[0]
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    with tracing.span("fsgm.flow", frames=b):
        chunk = (_frames_a_pass(imgs1, params) if chunk is None
                 else min(chunk, b))
        while b % chunk:
            chunk -= 1
        flows, valids = zip(*[_flow(imgs1[k:k + chunk], imgs2[k:k + chunk],
                                    params, None, plain=False)
                              for k in range(0, b, chunk)])
        return torch.cat(flows), torch.cat(valids)


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
