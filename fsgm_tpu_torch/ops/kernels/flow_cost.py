"""K6 flow_cost: the fSGM flow cost volume of one level, label-minor.

Replaces no Pallas kernel: the JAX package builds the flow cost volume in
XLA (fsgm_tpu/ops/cost.py::cost_volume_flow_major), and its TPU backend
turns the label-major planes into the label-minor layout its sweeps read
(K5, ops/kernels/transpose.py).  The CUDA kernel (csrc/flow_cost.cu) does
both in one launch over all N slices of a level: the warp gather, XOR,
popcount and invalid test, stored as the ([N,] H, W, nl_pad) u8 volume
that K2 reads, with the values of

    label_minor_from_major_plain(cost_volume_flow_major(...))

(``flow_cost_plain``, the CPU route and the card's reference).  Tiled mode
(parallel/tiled_flow.py) passes bases extended by ``radius`` true halo rows
on each side, the whole second image and the tile's first global row
``y_offset``, as cost_volume_flow_major takes them.

``census_bits`` is the width of the census window's words (every word lies
below 2^census_bits: ``FlowParams.census_bits``, 24 for config 4's 5x5
window); up to WORD32_BITS the kernel stages 32-bit words and counts one
32-bit popcount a byte.  The callers take it from the census window they
hold, never from the data; the plain version refuses a word wider than it
says.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.ops.cost import cost_volume_flow_major
from fsgm_tpu_torch.ops.kernels import _build
from fsgm_tpu_torch.ops.kernels.transpose import label_minor_from_major_plain
from fsgm_tpu_torch.utils import tracing

# csrc/flow_cost.cu: kGroup, kMaxRadius, kGroup x kMaxGroups, kWord32Bits
LABEL_GROUP = 16
MAX_RADIUS = 7
MAX_SLOTS = 256
WORD32_BITS = 31  # bit 31 of a 32-bit staged word marks it invalid


def _check(cen1, cen2, base_u, base_v, radius: int, invalid_cost: int,
           nl_pad: int, census_bits: int) -> tuple:
    """Raises on what neither route takes; returns (N, H, W, second-image
    rows, base rows)."""
    if cen1.dtype != torch.int64 or cen2.dtype != torch.int64:
        raise TypeError("flow_cost takes int64 census descriptors")
    if base_u.dtype != torch.int32 or base_v.dtype != torch.int32:
        raise TypeError("flow_cost takes int32 bases")
    if cen1.dim() not in (2, 3) or any(
            x.dim() != cen1.dim() for x in (cen2, base_u, base_v)):
        raise ValueError(f"flow_cost takes (H, W) or (N, H, W) census and "
                         f"bases, got {tuple(cen1.shape)}, "
                         f"{tuple(cen2.shape)}, {tuple(base_u.shape)}")
    c1, c2, bu = (x[None] if x.dim() == 2 else x
                  for x in (cen1, cen2, base_u))
    n, h, w = c1.shape
    if base_u.shape != base_v.shape or c2.shape[0] != n \
            or c2.shape[2] != w or bu.shape[0] != n or bu.shape[2] != w \
            or bu.shape[1] not in (h, h + 2 * radius):
        raise ValueError(f"flow_cost: census {tuple(cen1.shape)}, second "
                         f"image {tuple(cen2.shape)} and bases "
                         f"{tuple(base_u.shape)}, {tuple(base_v.shape)} at "
                         f"radius {radius}")
    if any(x.device != cen1.device for x in (cen2, base_u, base_v)):
        raise ValueError("flow_cost inputs lie on different devices")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"flow_cost takes a radius in 0..{MAX_RADIUS}, got "
                         f"{radius}")
    nl = (2 * radius + 1) ** 2
    if nl_pad % LABEL_GROUP or not nl <= nl_pad <= MAX_SLOTS:
        raise ValueError(f"nl_pad {nl_pad} must be a multiple of "
                         f"{LABEL_GROUP} in {nl}..{MAX_SLOTS}")
    if not 0 <= invalid_cost <= 255:
        raise ValueError("invalid_cost must fit u8")
    if not 1 <= census_bits <= 64:
        raise ValueError(f"census_bits {census_bits} must lie in 1..64")
    return n, h, w, c2.shape[1], bu.shape[1]


def flow_cost_plain(cen1: torch.Tensor, cen2: torch.Tensor,
                    base_u: torch.Tensor, base_v: torch.Tensor, radius: int,
                    invalid_cost: int, nl_pad: int, y_offset: int = 0,
                    census_bits: int = 64) -> torch.Tensor:
    """Plain PyTorch version: the label-major build and one axis exchange;
    raises where a census word does not fit census_bits."""
    if census_bits < 64 and any(bool(((c >> census_bits) != 0).any())
                                for c in (cen1, cen2)):
        raise ValueError(f"a census word is wider than census_bits = "
                         f"{census_bits}")
    return label_minor_from_major_plain(cost_volume_flow_major(
        cen1, cen2, base_u, base_v, radius, invalid_cost, nl_pad, y_offset))


def flow_cost(cen1: torch.Tensor, cen2: torch.Tensor, base_u: torch.Tensor,
              base_v: torch.Tensor, radius: int, invalid_cost: int,
              nl_pad: int, y_offset: int = 0,
              census_bits: int = 64) -> torch.Tensor:
    """(H, W) or (N, H, W) int64 census pairs and int32 bases (H or H + 2
    radius rows) -> contiguous ([N,] H, W, nl_pad) u8 flow cost volume, one
    launch for all N slices of a CUDA tensor; every census word below
    2^census_bits."""
    n, h, w, h2, hb = _check(cen1, cen2, base_u, base_v, radius,
                             invalid_cost, nl_pad, census_bits)
    if cen1.device.type == "cpu":
        return flow_cost_plain(cen1, cen2, base_u, base_v, radius,
                               invalid_cost, nl_pad, y_offset, census_bits)
    if cen1.device.type != "cuda":
        raise ValueError(f"flow_cost: unsupported device {cen1.device}")
    if not all(x.is_contiguous() for x in (cen1, cen2, base_u, base_v)):
        raise ValueError("flow_cost takes contiguous tensors")
    out = torch.empty(tuple(cen1.shape) + (nl_pad,), dtype=torch.uint8,
                      device=cen1.device)
    if out.numel() == 0:
        return out
    fn = _build.load("flow_cost")
    with _build.on_device(cen1):
        err = fn(cen1.data_ptr(), cen2.data_ptr(), base_u.data_ptr(),
                 base_v.data_ptr(), out.data_ptr(), n, h, w, h2, hb, radius,
                 invalid_cost, nl_pad, y_offset, census_bits,
                 _build.stream_of(cen1))
    _build.check(err, "flow_cost")
    tracing.launched("flow_cost")
    return out
