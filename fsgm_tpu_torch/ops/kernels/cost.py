"""K1 census_cost: the stereo matching cost volume of one frame or a batch.

Replaces fsgm_tpu/ops/pallas/cost_tr.py::cost_volume_wlh,
::cost_volume_hlw and ::cost_volume_wlh_batch.  The port keeps one
label-minor (B, H, W, D) u8 layout, which every sweep direction reads
coalesced, so the TPU's two transposed layouts, its lane-folded batch
layout and their neutral-zero pad rows and lanes have no counterpart:

    left reference:   C[b, y, x, d] = popcount(cenL[b, y, x] ^ cenR[b, y, x - d]),
                      invalid_cost where x - d < 0;
    right reference:  C[b, y, x, d] = popcount(cenR[b, y, x] ^ cenL[b, y, x + d]),
                      invalid_cost where x + d >= W
                      (fsgm_tpu/ops/cost.py::cost_volume_stereo_right, the
                      input of lr_mode="reagg").

``census_bits`` is the width of the census window's words (every word
lies below 2^census_bits: ``SGMParams.census_bits``, 24 for the 5x5 window
of configs 1, 2 and 5); up to 32 the kernel counts one 32-bit word a byte.
The callers take it from the census window they hold, never from the data;
the plain version refuses a word wider than it says.

``census_cost`` launches the CUDA kernel (csrc/cost.cu) once for all B
frames of a CUDA tensor and takes ``census_cost_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.ops.census import hamming
from fsgm_tpu_torch.ops.kernels import _build
from fsgm_tpu_torch.utils import tracing


WORD32_BITS = 32  # csrc/cost.cu: census_bits up to this take 32-bit words


def popcounts_per_byte(census_bits: int) -> int:
    """32-bit POPC instructions the kernel spends on one cost byte: one for
    census words of up to WORD32_BITS bits, two (a 64-bit popcount)
    above."""
    return 1 if census_bits <= WORD32_BITS else 2


def _check_bits(census_bits: int) -> None:
    if not 1 <= census_bits <= 64:
        raise ValueError(f"census_bits {census_bits} must lie in 1..64")


def census_cost_plain(cen_l: torch.Tensor, cen_r: torch.Tensor,
                      max_disp: int, invalid_cost: int = 255,
                      right_reference: bool = False,
                      census_bits: int = 64) -> torch.Tensor:
    """Plain PyTorch version over (..., H, W) census, vectorised over D;
    raises where a word does not fit census_bits."""
    _check_bits(census_bits)
    if census_bits < 64 and any(bool(((c >> census_bits) != 0).any())
                                for c in (cen_l, cen_r)):
        raise ValueError(f"a census word is wider than census_bits = "
                         f"{census_bits}")
    w = cen_l.shape[-1]
    xs = torch.arange(w, device=cen_l.device)[:, None]
    ds = torch.arange(max_disp, device=cen_l.device)[None, :]
    if right_reference:
        src, ref, match = xs + ds, cen_r, cen_l               # (W, D)
        inside = src < w
    else:
        src, ref, match = xs - ds, cen_l, cen_r
        inside = src >= 0
    c = hamming(ref[..., None], match[..., src.clamp(0, w - 1)])
    return torch.where(inside, c, invalid_cost).to(torch.uint8)


def census_cost(cen_l: torch.Tensor, cen_r: torch.Tensor, max_disp: int,
                invalid_cost: int = 255, right_reference: bool = False,
                census_bits: int = 64) -> torch.Tensor:
    """(H, W) or (B, H, W) int64 census pair -> (..., H, W, D) u8 cost
    volume (left reference, or right reference for lr_mode="reagg"); every
    word below 2^census_bits."""
    if cen_l.dtype != torch.int64 or cen_r.dtype != torch.int64:
        raise TypeError("census_cost takes int64 census descriptors")
    if cen_l.dim() not in (2, 3) or cen_l.shape != cen_r.shape:
        raise ValueError(f"census shapes {tuple(cen_l.shape)} and "
                         f"{tuple(cen_r.shape)} must be equal (H, W) or "
                         f"(B, H, W)")
    if cen_l.device != cen_r.device:
        raise ValueError("census_cost inputs lie on different devices")
    if not 0 <= invalid_cost <= 255 or not 0 < max_disp <= 256:
        raise ValueError("invalid_cost must fit u8 and 0 < max_disp <= 256")
    _check_bits(census_bits)
    if cen_l.device.type == "cpu":
        return census_cost_plain(cen_l, cen_r, max_disp, invalid_cost,
                                 right_reference, census_bits)
    if cen_l.device.type != "cuda":
        raise ValueError(f"census_cost: unsupported device {cen_l.device}")
    if not (cen_l.is_contiguous() and cen_r.is_contiguous()):
        raise ValueError("census_cost takes contiguous tensors")
    out = torch.empty(tuple(cen_l.shape) + (max_disp,), dtype=torch.uint8,
                      device=cen_l.device)
    if out.numel() == 0:
        return out
    h, w = cen_l.shape[-2:]
    b = cen_l.shape[0] if cen_l.dim() == 3 else 1
    fn = _build.load("census_cost")
    with _build.on_device(cen_l):
        err = fn(cen_l.data_ptr(), cen_r.data_ptr(), out.data_ptr(), b, h, w,
                 max_disp, invalid_cost, int(right_reference), census_bits,
                 _build.stream_of(cen_l))
    _build.check(err, "census_cost")
    tracing.launched("census_cost")
    return out
