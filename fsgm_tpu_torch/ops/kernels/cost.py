"""K1 census_cost: the stereo matching cost volume.

Replaces fsgm_tpu/ops/pallas/cost_tr.py::cost_volume_wlh and
::cost_volume_hlw.  The port keeps one label-minor (H, W, D) u8 layout,
which every sweep direction reads coalesced, so the TPU's two transposed
layouts and their neutral-zero pad rows and lanes have no counterpart:

    C[y, x, d] = popcount(cenL[y, x] ^ cenR[y, x - d]),
    invalid_cost where x - d < 0.

``census_cost`` launches the CUDA kernel (csrc/cost.cu) for CUDA tensors
and takes ``census_cost_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.ops.census import hamming
from fsgm_tpu_torch.ops.kernels import _build


def census_cost_plain(cen_l: torch.Tensor, cen_r: torch.Tensor,
                      max_disp: int, invalid_cost: int = 255
                      ) -> torch.Tensor:
    """Plain PyTorch version, vectorised over D."""
    h, w = cen_l.shape
    src = (torch.arange(w, device=cen_l.device)[:, None]
           - torch.arange(max_disp, device=cen_l.device)[None, :])  # (W, D)
    c = hamming(cen_l[:, :, None], cen_r[:, src.clamp(min=0)])
    return torch.where(src >= 0, c, invalid_cost).to(torch.uint8)


def census_cost(cen_l: torch.Tensor, cen_r: torch.Tensor, max_disp: int,
                invalid_cost: int = 255) -> torch.Tensor:
    """(H, W) int64 census pair -> (H, W, D) u8 cost volume."""
    if cen_l.dtype != torch.int64 or cen_r.dtype != torch.int64:
        raise TypeError("census_cost takes int64 census descriptors")
    if cen_l.dim() != 2 or cen_l.shape != cen_r.shape:
        raise ValueError(f"census shapes {tuple(cen_l.shape)} and "
                         f"{tuple(cen_r.shape)} must be equal (H, W)")
    if cen_l.device != cen_r.device:
        raise ValueError("census_cost inputs lie on different devices")
    if not 0 <= invalid_cost <= 255 or not 0 < max_disp <= 256:
        raise ValueError("invalid_cost must fit u8 and 0 < max_disp <= 256")
    if cen_l.device.type == "cpu":
        return census_cost_plain(cen_l, cen_r, max_disp, invalid_cost)
    if cen_l.device.type != "cuda":
        raise ValueError(f"census_cost: unsupported device {cen_l.device}")
    if not (cen_l.is_contiguous() and cen_r.is_contiguous()):
        raise ValueError("census_cost takes contiguous tensors")
    h, w = cen_l.shape
    out = torch.empty((h, w, max_disp), dtype=torch.uint8,
                      device=cen_l.device)
    if out.numel() == 0:
        return out
    fn = _build.load("cost")
    with torch.cuda.device(cen_l.device):
        err = fn(cen_l.data_ptr(), cen_r.data_ptr(), out.data_ptr(), h, w,
                 max_disp, invalid_cost, _build.stream_of(cen_l))
    _build.check(err, "census_cost")
    _build.LAUNCHES["census_cost"] += 1
    return out
