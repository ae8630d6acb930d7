"""Census transform and Hamming distance in plain PyTorch.

Counterpart of fsgm_tpu/ops/census.py.  The JAX package leaves census to
XLA, so the port leaves it to PyTorch's own kernels on the CPU and the GPU
alike.  Differences of representation, not of value:

  * a descriptor is ONE int64 word (windows up to 62 bits; JAX packs
    uint32 words) — PyTorch on the CPU cannot shift uint32, and one word
    keeps the cost kernel to a single popcount;
  * popcount is SWAR bit arithmetic — PyTorch has no popcount op.  The
    top bit of a descriptor is never set, so the arithmetic shifts of
    int64 act as logical ones.

Bit order matches golden/sgm.py::census_transform exactly: row-major
window scan, centre skipped, bit = neighbour < centre, edge padding.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.utils import tracing

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def census_transform(img: torch.Tensor, window=(5, 5)) -> torch.Tensor:
    """(..., H, W) integer images -> (..., H, W) int64 census descriptors,
    each frame edge-padded on its own."""
    ch, cw = window
    if ch * cw - 1 > 62 or ch % 2 == 0 or cw % 2 == 0:
        raise ValueError(f"census window {window} must be odd and <= 62 bits")
    if img.dim() < 2:
        raise ValueError(f"census_transform takes (..., H, W) images, got "
                         f"{tuple(img.shape)}")
    with tracing.span("fsgm.census"):
        ry, rx = ch // 2, cw // 2
        h, w = img.shape[-2:]
        centre = img.to(torch.int32)
        rows = torch.arange(-ry, h + ry, device=img.device).clamp_(0, h - 1)
        cols = torch.arange(-rx, w + rx, device=img.device).clamp_(0, w - 1)
        padded = centre.index_select(-2, rows).index_select(-1, cols)
        out = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
        bit = 0
        for oy in range(ch):
            for ox in range(cw):
                if oy == ry and ox == rx:
                    continue
                neighbour = padded[..., oy:oy + h, ox:ox + w]
                out |= (neighbour < centre).to(torch.int64) << bit
                bit += 1
        return out


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Bit count of non-negative int64 values, as int32."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return (x & 0x7F).to(torch.int32)


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between int64 census descriptors, int32."""
    return popcount64(a ^ b)
