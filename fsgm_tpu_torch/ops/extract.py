"""Disparity extraction in plain PyTorch: WTA, subpixel, LR check, median,
invalid-pixel fill.

Counterpart of fsgm_tpu/ops/extract.py on the label-minor (H, W, D) S; every
function also takes leading batch dimensions ((B, H, W, D) S, (B, H, W)
fields) and treats each frame on its own.  ``subpixel_from_neighborhood``,
``lr_check`` (lr_mode="reagg"), ``median_filter_3x3`` and
``interpolate_invalid`` are the main path's tail after the extraction
kernel, in the JAX package's order LR -> median -> fill (XLA there, plain
PyTorch here).  ``wta``, ``neighborhood_of_min``, ``wta_right_from_s`` and
``lr_valid`` are the plain references the extraction kernel is held to
(ops/kernels/extract.py).

WTA takes the minimum of the packed key (S << 8) | d, so ties go to the
smallest d by construction (S < 2^23, D <= 256).
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.params import INVALID
from fsgm_tpu_torch.utils import tracing

BIG = 1 << 24  # out-of-range neighbourhood sentinel (callers gate on interior)


def _packed(s: torch.Tensor) -> torch.Tensor:
    lab = torch.arange(s.shape[-1], dtype=torch.int32, device=s.device)
    return (s.to(torch.int32) << 8) | lab


def wta(s: torch.Tensor) -> torch.Tensor:
    """argmin over the last (label) axis, smallest d on ties; int32."""
    return _packed(s).amin(dim=-1) & 255


def neighborhood_of_min(s: torch.Tensor, d_int: torch.Tensor):
    """(S[d*-1], S[d*], S[d*+1]) as int32 maps by one-hot minima; BIG where
    the neighbour label is out of range."""
    lab = torch.arange(s.shape[-1], dtype=torch.int32, device=s.device)
    d = d_int[..., None]
    sv = s.to(torch.int32)

    def pick(target):
        return torch.where(lab == target, sv, BIG).amin(dim=-1)
    return pick(d - 1), pick(d), pick(d + 1)


def wta_right_from_s(s: torch.Tensor, s_invalid: int, gx0: int = 0,
                     w_global: int | None = None) -> torch.Tensor:
    """Right-view disparity by the S-volume trick: argmin_d S(y, x+d, d),
    s_invalid where x+d >= W, smallest d on ties.  One index-arithmetic
    gather of the diagonal within each row.  Column tiling: S spans a
    window whose column x sits at the global column gx0 + x of an image
    w_global wide, and a match also needs gx0 + x + d < w_global."""
    w, nd = s.shape[-2:]
    lab = torch.arange(nd, device=s.device)
    src = torch.arange(w, device=s.device)[:, None] + lab[None, :]  # (W, D)
    valid = src < w
    if w_global is not None:
        valid &= gx0 + src < w_global
    flat = (src.clamp(max=w - 1) * nd + lab).reshape(-1)
    diag = s.reshape(s.shape[:-2] + (w * nd,))[..., flat].reshape(s.shape)
    diag = torch.where(valid, diag.to(torch.int32), s_invalid)
    return wta(diag)


def subpixel_from_neighborhood(d_int, s_m, s_0, s_p, nd: int
                               ) -> torch.Tensor:
    """Parabola refinement in float32 from (S[d*-1], S[d*], S[d*+1])."""
    fm, f0, fp = (x.to(torch.float32) for x in (s_m, s_0, s_p))
    denom = fm - 2.0 * f0 + fp
    ok = (d_int > 0) & (d_int < nd - 1) & (denom > 0)
    offset = torch.where(ok, (fm - fp) / torch.clamp(2.0 * denom, min=1e-12),
                         0.0).clamp(-0.5, 0.5)
    return d_int.to(torch.float32) + torch.where(ok, offset, 0.0)


def lr_valid(d_left: torch.Tensor, d_right: torch.Tensor,
             max_diff: int = 1, max_disp: int | None = None,
             x_lo: int = 0) -> torch.Tensor:
    """Bool plane: 0 <= dr < max_disp (default W), x - dr >= x_lo and |dr -
    d_R(x - dr)| <= max_diff, dr = rint(d_L(x)) (half to even); the lookup
    stays in the pixel's own row.  fsgm_tpu/ops/extract.py::lr_check's
    rule: a rounded disparity outside [0, max_disp) fails.  x_lo > 0 is a
    window's first column inside the image (column tiling): a lookup left
    of it fails, as the JAX tiled path's d_R = -2^20 there makes it."""
    w = d_left.shape[-1]
    d_round = torch.round(d_left).to(torch.int64)
    src = torch.arange(w, device=d_left.device) - d_round
    inside = (d_round >= 0) & (d_round < (w if max_disp is None
                                          else max_disp)) & (src >= x_lo)
    d_r = torch.gather(d_right.to(torch.int64), -1, src.clamp(0, w - 1))
    return inside & ((d_round - d_r).abs() <= max_diff)


def lr_check(d_left: torch.Tensor, d_right: torch.Tensor,
             max_diff: int = 1, max_disp: int | None = None,
             x_lo: int = 0) -> torch.Tensor:
    """d_left with INVALID where the left-right check against the given
    right-view disparity d_right fails (lr_valid)."""
    return torch.where(lr_valid(d_left, d_right, max_diff, max_disp, x_lo),
                       d_left, INVALID)


def median_filter_3x3(field: torch.Tensor) -> torch.Tensor:
    """3x3 median with edge-replicate padding at each frame's own edge (the
    5th of 9 values)."""
    with tracing.span("fsgm.median"):
        h, w = field.shape[-2:]
        rows = torch.arange(-1, h + 1, device=field.device).clamp_(0, h - 1)
        cols = torch.arange(-1, w + 1, device=field.device).clamp_(0, w - 1)
        padded = field.index_select(-2, rows).index_select(-1, cols)
        stack = torch.stack([padded[..., dy:dy + h, dx:dx + w]
                             for dy in range(3) for dx in range(3)])
        return stack.sort(dim=0).values[4]


def interpolate_invalid(field: torch.Tensor) -> torch.Tensor:
    """Row-wise background fill of INVALID (< 0) pixels, equal to
    fsgm_tpu/ops/extract.py::interpolate_invalid: each invalid pixel takes
    the smaller of its nearest valid left and right row neighbours (one
    side where only one exists); rows with no valid pixel stay INVALID.
    The nearest valid column on each side is a running max / min of
    column indices (cummax) instead of the JAX package's doubling."""
    w = field.shape[-1]
    valid = field >= 0
    xs = torch.arange(w, device=field.device).expand(field.shape)
    left = torch.where(valid, xs, -1).cummax(dim=-1).values
    right = torch.where(valid, xs, w).flip(-1).cummin(dim=-1).values.flip(-1)
    from_left = torch.where(left >= 0, field.gather(-1, left.clamp(min=0)),
                            float("inf"))
    from_right = torch.where(right < w,
                             field.gather(-1, right.clamp(max=w - 1)),
                             float("inf"))
    fill = torch.minimum(from_left, from_right)
    fill = torch.where(torch.isinf(fill), INVALID, fill)
    return torch.where(valid, field, fill)
