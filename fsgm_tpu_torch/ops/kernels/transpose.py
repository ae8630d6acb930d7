"""K5 label_minor_from_major: u8 (H, L, W) -> (H, W, L).

Replaces fsgm_tpu/ops/pallas/transpose_pallas.py::label_minor_from_major,
which ran the TPU flow backend's label-major cost planes through an
in-VMEM butterfly into the label-minor layout its sweeps read (L padded to
128, W to a multiple of 128).  Here any L and W: the CUDA kernel
(csrc/transpose.cu) is a shared-memory tiled transpose, and
``label_minor_from_major_plain`` is PyTorch's own axis exchange, which the
port's GPU path never calls.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.ops.kernels import _build


def label_minor_from_major_plain(vol: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one strided copy."""
    return vol.transpose(1, 2).contiguous()


def label_minor_from_major(vol: torch.Tensor) -> torch.Tensor:
    """(H, L, W) uint8 label-major volume -> contiguous (H, W, L)."""
    if vol.dtype != torch.uint8 or vol.dim() != 3:
        raise TypeError("label_minor_from_major takes an (H, L, W) uint8 "
                        "volume")
    if vol.device.type == "cpu":
        return label_minor_from_major_plain(vol)
    if vol.device.type != "cuda":
        raise ValueError(f"label_minor_from_major: unsupported device "
                         f"{vol.device}")
    h, nl, w = vol.shape
    if not vol.is_contiguous() or h > 65535:
        raise ValueError(f"label_minor_from_major kernel needs a contiguous "
                         f"volume with H <= 65535, got {tuple(vol.shape)}")
    out = torch.empty((h, w, nl), dtype=torch.uint8, device=vol.device)
    if out.numel() == 0:
        return out
    fn = _build.load("label_minor_from_major")
    with _build.on_device(vol):
        err = fn(vol.data_ptr(), out.data_ptr(), h, nl, w,
                 _build.stream_of(vol))
    _build.check(err, "label_minor_from_major")
    _build.LAUNCHES["label_minor_from_major"] += 1
    return out
