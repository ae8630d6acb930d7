"""Stereo SGM pipeline in PyTorch: census -> K1 cost -> K2 sweeps -> K3
extraction -> subpixel / LR / median / fill tail.

Counterpart of fsgm_tpu/models/stereo.py (``stereo_sgm``,
``stereo_sgm_batch``, ``right_disparity_reagg``).  One code path serves a
batch of B frames and a single frame (B = 1): census of the (B, H, W)
images, one K1 launch, the K2 launches (one per direction, or one family
launch per direction group where that fills the card better:
ops/kernels/aggregate.py::aggregate_paths) and one K3 launch for all B
frames, then the plain-torch tail over (B, H, W), so each frame of a batch
is bit for bit the frame alone.  The device is the inputs' device:
CUDA tensors launch the hand-written kernels (ops/kernels), CPU tensors run
their plain versions.  ``stereo_sgm_reference`` and
``stereo_sgm_batch_reference`` compose only the plain versions, on any
device, as the end-to-end check of the kernels.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.params import INVALID, SGMParams
from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.kernels import aggregate, cost, extract
from fsgm_tpu_torch.utils import tracing


def _check(imgs_l: torch.Tensor, imgs_r: torch.Tensor, dims: int) -> None:
    shape = "(H, W)" if dims == 2 else "(B, H, W)"
    if imgs_l.shape != imgs_r.shape or imgs_l.dim() != dims:
        raise ValueError(f"image shapes {tuple(imgs_l.shape)} and "
                         f"{tuple(imgs_r.shape)} must be equal {shape}")
    if imgs_l.device != imgs_r.device:
        raise ValueError("images lie on different devices")


def _s_volume(cen_ref: torch.Tensor, cen_match: torch.Tensor,
              guide: torch.Tensor, params: SGMParams, plain: bool,
              right_reference: bool = False) -> torch.Tensor:
    """(B, H, W, D) S of the left (or right) reference view; P2' guided by
    that view's images.  The cost volume is freed when this returns."""
    build_cost = cost.census_cost_plain if plain else cost.census_cost
    aggregate_paths = (aggregate.aggregate_paths_plain if plain
                       else aggregate.aggregate_paths)
    with tracing.span("fsgm.cost"):
        c = build_cost(cen_ref, cen_match, params.max_disp,
                       params.invalid_cost, right_reference,
                       params.census_bits)
    return aggregate_paths(c, guide, params.dirs, params.p1, params.p2,
                           params.adaptive_p2, s_max=params.s_invalid)


def _extract(s: torch.Tensor, params: SGMParams, plain: bool, **kw):
    fn = extract.extract_stereo_plain if plain else extract.extract_stereo
    with tracing.span("fsgm.extract"):
        return fn(s, params.s_invalid, params.lr_max_diff, **kw)


def right_disparity_reagg(cen_l: torch.Tensor, cen_r: torch.Tensor,
                          imgs_r: torch.Tensor, params: SGMParams,
                          plain: bool = False) -> torch.Tensor:
    """True LR re-aggregation (lr_mode="reagg"): the right-reference cost
    volume (K1, right_reference), full SGM over it guided by the right
    images (K2), and its WTA (K3 without the right-view pass): (B, H, W)
    int32 right-view disparity, smallest d on ties.  S_R uses the same
    plan_dtypes(s_invalid) as the left S."""
    with tracing.span("fsgm.reagg"):
        s_r = _s_volume(cen_l, cen_r, imgs_r, params, plain,
                        right_reference=True)
        return _extract(s_r, params, plain, with_sub=False,
                        with_rwta=False)[0]


def _stereo(imgs_l: torch.Tensor, imgs_r: torch.Tensor, params: SGMParams,
            plain: bool) -> torch.Tensor:
    """(B, H, W) uint8 pairs -> (B, H, W) float32 disparity."""
    with tracing.span("fsgm.stereo", frames=imgs_l.shape[0]):
        cen_l = census_transform(imgs_l, params.census_window)
        cen_r = census_transform(imgs_r, params.census_window)
        d_right = None
        if params.lr_check and params.lr_mode == "reagg":
            # first, so that S_R is freed before the left S exists
            d_right = right_disparity_reagg(cen_l, cen_r, imgs_r, params,
                                            plain)
        s = _s_volume(cen_l, cen_r, imgs_l, params, plain)
        planes = _extract(s, params, plain, with_sub=params.subpixel,
                          with_rwta=params.lr_check and d_right is None)
        del s
        return disparity_tail(planes, params, d_right)


def disparity_tail(planes, params: SGMParams,
                   d_right: torch.Tensor | None = None) -> torch.Tensor:
    """K3's planes (d_int, s_m, s_0, s_p, valid; valid None without its
    right-view pass) -> (B, H, W) float32 disparity: subpixel, the LR check
    (by K3's valid plane, or against ``d_right``, the re-aggregated right
    view), median and fill."""
    with tracing.span("fsgm.tail"):
        d_int, s_m, s_0, s_p, valid = planes
        disp = d_int.to(torch.float32)
        if params.subpixel:
            disp = ext.subpixel_from_neighborhood(d_int, s_m, s_0, s_p,
                                                  params.max_disp)
        if params.lr_check:
            if d_right is None:
                disp = torch.where(valid != 0, disp, INVALID)
            else:
                disp = ext.lr_check(disp, d_right, params.lr_max_diff,
                                    params.max_disp)
        if params.median_filter:
            disp = ext.median_filter_3x3(disp)
        if params.fill_invalid:
            disp = ext.interpolate_invalid(disp)
        return disp


def stereo_sgm(img_l: torch.Tensor, img_r: torch.Tensor,
               params: SGMParams) -> torch.Tensor:
    """(H, W) uint8 pair -> (H, W) float32 disparity, INVALID = -1."""
    _check(img_l, img_r, 2)
    return _stereo(img_l[None], img_r[None], params, plain=False)[0]


def stereo_sgm_reference(img_l: torch.Tensor, img_r: torch.Tensor,
                         params: SGMParams) -> torch.Tensor:
    """stereo_sgm through the plain PyTorch versions only."""
    _check(img_l, img_r, 2)
    return _stereo(img_l[None], img_r[None], params, plain=True)[0]


def stereo_sgm_batch(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                     params: SGMParams) -> torch.Tensor:
    """(B, H, W) uint8 pairs -> (B, H, W) float32: one pass for all B
    frames (one K1 launch, the K2 launches of aggregate_paths, one K3
    launch, and under lr_mode="reagg" the same again for the right view);
    each frame bit-identical to stereo_sgm on that frame."""
    _check(imgs_l, imgs_r, 3)
    return _stereo(imgs_l, imgs_r, params, plain=False)


def stereo_sgm_batch_reference(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                               params: SGMParams) -> torch.Tensor:
    """stereo_sgm_batch through the plain PyTorch versions only."""
    _check(imgs_l, imgs_r, 3)
    return _stereo(imgs_l, imgs_r, params, plain=True)
