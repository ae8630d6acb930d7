"""Flow cost volumes in plain PyTorch (the JAX package builds them in XLA).

Counterpart of fsgm_tpu/ops/cost.py::_flow_cost_planes, cost_volume_flow
and cost_volume_flow_major.  Over the (2w+1)^2 label window centred on the
rounded prior flow, label l = (dv+w)*(2w+1) + (du+w):

    cen2w[y, x]  = cen2[y + base_v, x + base_u]    (warp once, per pixel)
    C[y, x, l]   = popcount(cen1[y, x] ^ cen2w[y + dv, x + du]),
                   invalid_cost where (y + dv, x + du) or its warp source
                   lies outside the image.

Tiled mode of cost_volume_flow_major (fsgm_tpu_torch/parallel/
tiled_flow.py): cen1 is a row tile whose first row is the global row
y_offset, cen2 the full second image, and base_u / base_v arrive extended
by ``radius`` true halo rows on each side (the dv shifts read warped
descriptors across the tile's seams); rows outside the second image are
invalid.  Untiled calls pass unextended bases and y_offset 0.

Every function takes one (H, W) slice or N slices (N, H, W), each with
its own cen1, cen2, base_u and base_v (the forward and backward passes of
several frames, models/flow.py); the warp's flat gather index carries the
slice's offset n * H2 * W.

Vectorised over labels: one gather warps the descriptors, a zero / False
border of w pixels makes every window position addressable, and one
strided copy of the (2w+1) x (2w+1) windows feeds a few whole-volume
integer ops, so a build is a few dozen launches whatever the label count.
The JAX package's block warp (warp_census_blocked) and its identity-base
shortcut at the coarsest level are gathers with identical values and are
not ported: the per-pixel gather serves every level.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.ops.census import hamming


def _slices(cen1: torch.Tensor, cen2: torch.Tensor, base_u: torch.Tensor,
            base_v: torch.Tensor):
    """The inputs as N slices ((N, H, W), a 2-D call one slice), checked to
    agree on N."""
    if cen1.dim() not in (2, 3) or any(
            x.dim() != cen1.dim() for x in (cen2, base_u, base_v)):
        raise ValueError(f"flow cost takes (H, W) or (N, H, W) census and "
                         f"bases, got {tuple(cen1.shape)}, "
                         f"{tuple(cen2.shape)}, {tuple(base_u.shape)}")
    if cen1.dim() == 2:
        return cen1[None], cen2[None], base_u[None], base_v[None]
    n = cen1.shape[0]
    if any(x.shape[0] != n for x in (cen2, base_u, base_v)):
        raise ValueError(f"flow cost: slice counts {cen1.shape[0]}, "
                         f"{cen2.shape[0]}, {base_u.shape[0]}, "
                         f"{base_v.shape[0]} differ")
    return cen1, cen2, base_u, base_v


def _warped_windows(cen1: torch.Tensor, cen2: torch.Tensor,
                    base_u: torch.Tensor, base_v: torch.Tensor, radius: int,
                    y_offset: int = 0):
    """Views (N, H, W, e, e) of the warped descriptors and their validity
    at window position [n, y, x, dv + w, du + w] (e = 2w + 1) of N slices
    ((N, H, W) inputs)."""
    n, h, w = cen1.shape
    h2 = cen2.shape[1]
    hb = base_u.shape[1]             # h (untiled) or h + 2 radius (tiled)
    halo = (hb - h) // 2
    if hb != h + 2 * halo or halo not in (0, radius) \
            or cen2.shape[2] != w:
        raise ValueError(f"flow cost: base rows {hb} for a {h}-row tile "
                         f"with radius {radius}, second image "
                         f"{tuple(cen2.shape[1:])}")
    dev = cen1.device
    yy = (torch.arange(hb, device=dev, dtype=torch.int32)[:, None]
          - halo + y_offset)         # the base rows' global rows
    xx = torch.arange(w, device=dev, dtype=torch.int32)[None, :]
    sy = yy + base_v
    sx = xx + base_u
    ok_w = (sy >= 0) & (sy < h2) & (sx >= 0) & (sx < w) & (yy >= 0) \
        & (yy < h2)
    frame = torch.arange(n, device=dev, dtype=torch.int64)[:, None, None]
    src = (frame * h2 + sy.clamp(0, h2 - 1)) * w + sx.clamp(0, w - 1)
    r, e = radius, 2 * radius + 1
    pad = r - halo
    cen2w = torch.zeros((n, h + 2 * r, w + 2 * r), dtype=cen2.dtype,
                        device=dev)
    ok = torch.zeros((n, h + 2 * r, w + 2 * r), dtype=torch.bool,
                     device=dev)
    cen2w[:, pad:pad + hb, r:r + w] = cen2.reshape(-1)[src]
    ok[:, pad:pad + hb, r:r + w] = ok_w
    return (cen2w.unfold(1, e, 1).unfold(2, e, 1),
            ok.unfold(1, e, 1).unfold(2, e, 1))


def _cost(cen1_b: torch.Tensor, win: torch.Tensor, ok: torch.Tensor,
          invalid_cost: int) -> torch.Tensor:
    return torch.where(ok, hamming(cen1_b, win),
                       invalid_cost).to(torch.uint8)


def cost_volume_flow(cen1: torch.Tensor, cen2: torch.Tensor,
                     base_u: torch.Tensor, base_v: torch.Tensor,
                     radius: int, invalid_cost: int = 255) -> torch.Tensor:
    """([N,] H, W, (2w+1)^2) uint8 label-minor flow cost volume: the plain
    reference, and golden/flow.py::cost_volume_flow's values."""
    one = cen1.dim() == 2
    cen1, cen2, base_u, base_v = _slices(cen1, cen2, base_u, base_v)
    n, h, w = cen1.shape
    nl = (2 * radius + 1) ** 2
    win, ok = _warped_windows(cen1, cen2, base_u, base_v, radius)
    out = _cost(cen1[..., None], win.reshape(n, h, w, nl),
                ok.reshape(n, h, w, nl), invalid_cost)
    return out[0] if one else out


def cost_volume_flow_major(cen1: torch.Tensor, cen2: torch.Tensor,
                           base_u: torch.Tensor, base_v: torch.Tensor,
                           radius: int, invalid_cost: int = 255,
                           nl_pad: int | None = None,
                           y_offset: int = 0) -> torch.Tensor:
    """([N,] H, nl_pad, W) uint8 label-major flow cost volume: label l's
    plane at [..., l, :], contiguous along W; planes past (2w+1)^2 up to
    nl_pad hold invalid_cost.  Same values as cost_volume_flow."""
    one = cen1.dim() == 2
    cen1, cen2, base_u, base_v = _slices(cen1, cen2, base_u, base_v)
    n, h, w = cen1.shape
    nl = (2 * radius + 1) ** 2
    nl_pad = nl if nl_pad is None else nl_pad
    if nl_pad < nl:
        raise ValueError(f"nl_pad {nl_pad} < {nl} labels")
    win, ok = _warped_windows(cen1, cen2, base_u, base_v, radius, y_offset)
    out = torch.full((n, h, nl_pad, w), invalid_cost, dtype=torch.uint8,
                     device=cen1.device)
    out[:, :, :nl] = _cost(cen1[:, :, None, :],
                           win.permute(0, 1, 3, 4, 2).reshape(n, h, nl, w),
                           ok.permute(0, 1, 3, 4, 2).reshape(n, h, nl, w),
                           invalid_cost)
    return out[0] if one else out
