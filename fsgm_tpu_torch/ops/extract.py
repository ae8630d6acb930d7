"""Disparity extraction in plain PyTorch: WTA, subpixel, LR check, median.

Counterpart of fsgm_tpu/ops/extract.py on the label-minor (H, W, D) S.
``subpixel_from_neighborhood`` and ``median_filter_3x3`` are the main
path's tail after the extraction kernel (XLA in the JAX package, plain
PyTorch here).  ``wta``, ``neighborhood_of_min``, ``wta_right_from_s`` and
``lr_check`` are the plain references the extraction kernel is held to
(ops/kernels/extract.py).

WTA takes the minimum of the packed key (S << 8) | d, so ties go to the
smallest d by construction (S < 2^23, D <= 256).
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.params import INVALID

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


def wta_right_from_s(s: torch.Tensor, s_invalid: int) -> torch.Tensor:
    """Right-view disparity by the S-volume trick: argmin_d S(y, x+d, d),
    s_invalid where x+d >= W, smallest d on ties.  One index-arithmetic
    gather of the diagonal."""
    h, w, nd = s.shape
    lab = torch.arange(nd, device=s.device)
    src = torch.arange(w, device=s.device)[:, None] + lab[None, :]  # (W, D)
    flat = (src.clamp(max=w - 1) * nd + lab).reshape(-1)
    diag = s.reshape(h, w * nd)[:, flat].reshape(h, w, nd)
    diag = torch.where(src < w, diag.to(torch.int32), s_invalid)
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
             max_diff: int = 1) -> torch.Tensor:
    """Bool plane: |rint(d_L(x)) - d_R(x - rint(d_L(x)))| <= max_diff with
    the lookup column inside the row.  rint rounds half to even."""
    h, w = d_left.shape
    d_round = torch.round(d_left).to(torch.int64)
    src = torch.arange(w, device=d_left.device)[None, :] - d_round
    inside = (src >= 0) & (src < w)
    d_r = torch.gather(d_right.to(torch.int64), 1, src.clamp(0, w - 1))
    return inside & ((d_round - d_r).abs() <= max_diff)


def lr_check(d_left: torch.Tensor, d_right: torch.Tensor,
             max_diff: int = 1) -> torch.Tensor:
    """d_left with INVALID where the left-right check fails."""
    return torch.where(lr_valid(d_left, d_right, max_diff), d_left,
                       INVALID)


def median_filter_3x3(field: torch.Tensor) -> torch.Tensor:
    """3x3 median with edge-replicate padding (the 5th of 9 values)."""
    h, w = field.shape
    rows = torch.arange(-1, h + 1, device=field.device).clamp_(0, h - 1)
    cols = torch.arange(-1, w + 1, device=field.device).clamp_(0, w - 1)
    padded = field.index_select(0, rows).index_select(1, cols)
    stack = torch.stack([padded[dy:dy + h, dx:dx + w]
                         for dy in range(3) for dx in range(3)])
    return stack.sort(dim=0).values[4]
