"""K5 label_minor_from_major: u8 ([N,] H, L, W) -> ([N,] H, W, L).

Replaces fsgm_tpu/ops/pallas/transpose_pallas.py::label_minor_from_major,
which ran the TPU flow backend's label-major cost planes through an
in-VMEM butterfly into the label-minor layout its sweeps read (L padded to
128, W to a multiple of 128).  Here any L and W, at any base address: the
CUDA kernel (csrc/transpose.cu) takes tiles of TILE_W columns of one row
with all L labels where L is a multiple of LABEL_GROUP up to
MAX_TILED_LABELS (``tiled``; every flow path), and a generic 32 x 32 byte
tile otherwise.  A frame axis N (the slices of a flow level,
models/flow.py) is one launch over N * H rows: the kernels' offsets are
64-bit, and their grids are flat.  ``label_minor_from_major_plain`` is
PyTorch's own axis exchange, which the port's GPU path never calls.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.ops.kernels import _build
from fsgm_tpu_torch.utils import tracing

# the tiled kernel's layout (csrc/transpose.cu kChunk, kTileW, kRowChunks,
# kMaxGroups): 16 labels a warp and a 16-byte store, 128 columns a tile,
# the 9 aligned 16-byte chunks that cover a label row's 128 columns at any
# shift, 16 label groups at most; the C entry takes the row count as an int
LABEL_GROUP = 16
TILE_W = 128
ROW_CHUNKS = TILE_W // LABEL_GROUP + 1
MAX_TILED_LABELS = 256
MAX_ROWS = (1 << 31) - 1


def tiled(nl: int) -> bool:
    """Whether nl labels take the tiled kernel (else the generic one)."""
    return nl % LABEL_GROUP == 0 and 0 < nl <= MAX_TILED_LABELS


def staged_bytes(nl: int) -> int:
    """Shared memory of one tiled-kernel block (one tile) for nl labels:
    nl staged rows of ROW_CHUNKS chunks and the staged output, each 4-pixel
    quad at 4 G + 1 chunks for G = nl / 16 (csrc/transpose.cu
    smem_bytes)."""
    g = nl // LABEL_GROUP
    return (nl * ROW_CHUNKS * LABEL_GROUP
            + TILE_W // 4 * (4 * g + 1) * LABEL_GROUP)


def label_minor_from_major_plain(vol: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one strided copy."""
    return vol.transpose(-2, -1).contiguous()


def label_minor_from_major(vol: torch.Tensor) -> torch.Tensor:
    """([N,] H, L, W) uint8 label-major volume -> contiguous ([N,] H, W, L),
    one launch for all N frames."""
    if vol.dtype != torch.uint8 or vol.dim() not in (3, 4):
        raise TypeError("label_minor_from_major takes an (H, L, W) or (N, "
                        "H, L, W) uint8 volume")
    if vol.device.type == "cpu":
        return label_minor_from_major_plain(vol)
    if vol.device.type != "cuda":
        raise ValueError(f"label_minor_from_major: unsupported device "
                         f"{vol.device}")
    if not vol.is_contiguous():
        raise ValueError(f"label_minor_from_major kernel needs a contiguous "
                         f"volume, got strides {vol.stride()}")
    nl, w = vol.shape[-2:]
    rows = vol.shape[:-2].numel()  # N * H: one flat row axis
    if rows > MAX_ROWS:
        raise ValueError(f"label_minor_from_major kernel takes fewer than "
                         f"2^31 rows N * H, got {rows}")
    out = torch.empty(vol.shape[:-2] + (w, nl), dtype=torch.uint8,
                      device=vol.device)
    if out.numel() == 0:
        return out
    fn = _build.load("label_minor_from_major")
    with _build.on_device(vol):
        err = fn(vol.data_ptr(), out.data_ptr(), rows, nl, w,
                 _build.stream_of(vol))
    _build.check(err, "label_minor_from_major")
    tracing.launched("label_minor_from_major")
    return out
