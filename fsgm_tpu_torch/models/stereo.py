"""Stereo SGM pipeline in PyTorch: census -> K1 cost -> K2 sweeps -> K3
extraction -> subpixel / LR / median tail.

Counterpart of fsgm_tpu/models/stereo.py (``stereo_sgm``,
``stereo_sgm_batch``).  The device is the inputs' device: CUDA tensors
launch the hand-written kernels (ops/kernels), CPU tensors run their plain
versions.  ``stereo_sgm_reference`` composes only the plain versions, on any
device, as the end-to-end check of the kernels.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.params import INVALID, SGMParams
from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.kernels import aggregate, cost, extract


def _check(img_l: torch.Tensor, img_r: torch.Tensor,
           params: SGMParams) -> None:
    if img_l.shape != img_r.shape or img_l.dim() != 2:
        raise ValueError(f"image shapes {tuple(img_l.shape)} and "
                         f"{tuple(img_r.shape)} must be equal (H, W)")
    if img_l.device != img_r.device:
        raise ValueError("images lie on different devices")
    if params.lr_check and params.lr_mode == "reagg":
        raise NotImplementedError(
            "lr_mode='reagg' is not ported yet (ROADMAP A7)")
    if params.fill_invalid:
        raise NotImplementedError(
            "fill_invalid is not ported yet (ROADMAP A7)")


def _stereo(img_l: torch.Tensor, img_r: torch.Tensor, params: SGMParams,
            plain: bool) -> torch.Tensor:
    _check(img_l, img_r, params)
    build_cost = cost.census_cost_plain if plain else cost.census_cost
    aggregate_paths = (aggregate.aggregate_paths_plain if plain
                       else aggregate.aggregate_paths)
    extract_stereo = (extract.extract_stereo_plain if plain
                      else extract.extract_stereo)
    c = build_cost(census_transform(img_l, params.census_window),
                   census_transform(img_r, params.census_window),
                   params.max_disp, params.invalid_cost)
    s = aggregate_paths(c, img_l, params.dirs, params.p1, params.p2,
                        params.adaptive_p2, s_max=params.s_invalid)
    d_int, s_m, s_0, s_p, valid = extract_stereo(
        s, params.s_invalid, params.lr_max_diff, params.subpixel)
    disp = d_int.to(torch.float32)
    if params.subpixel:
        disp = ext.subpixel_from_neighborhood(d_int, s_m, s_0, s_p,
                                              params.max_disp)
    if params.lr_check:
        disp = torch.where(valid != 0, disp, INVALID)
    if params.median_filter:
        disp = ext.median_filter_3x3(disp)
    return disp


def stereo_sgm(img_l: torch.Tensor, img_r: torch.Tensor,
               params: SGMParams) -> torch.Tensor:
    """(H, W) uint8 pair -> (H, W) float32 disparity, INVALID = -1."""
    return _stereo(img_l, img_r, params, plain=False)


def stereo_sgm_reference(img_l: torch.Tensor, img_r: torch.Tensor,
                         params: SGMParams) -> torch.Tensor:
    """stereo_sgm through the plain PyTorch versions only."""
    return _stereo(img_l, img_r, params, plain=True)


def stereo_sgm_batch(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                     params: SGMParams) -> torch.Tensor:
    """(B, H, W) uint8 pairs -> (B, H, W) float32: each frame through the
    same kernels, one after another on the current stream."""
    if imgs_l.dim() != 3 or imgs_l.shape != imgs_r.shape:
        raise ValueError(f"batch shapes {tuple(imgs_l.shape)} and "
                         f"{tuple(imgs_r.shape)} must be equal (B, H, W)")
    return torch.stack([stereo_sgm(a, b, params)
                        for a, b in zip(imgs_l, imgs_r)])
