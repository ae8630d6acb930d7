"""K7 census: the census transform of an image batch in one launch.

Replaces no Pallas kernel: the JAX package leaves census to XLA
(fsgm_tpu/ops/census.py::census_transform).  The CUDA kernel
(csrc/census.cu) writes the (N, H, W) int64 descriptors of all N frames of
a call in one launch, with the values of ops/census.py::
census_transform_plain, the CPU route and the card's reference.  It reads
uint8 and int32 pixels as they are; any other integer dtype is converted
to int32 first, as the plain version's first step does.  Any odd window up
to 62 bits runs; the main path's 5x5 has its own unrolled instantiation.

``census`` takes CUDA tensors only: ops/census.py::census_transform checks
the arguments for both routes and sends a CPU tensor to the plain version.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.ops.kernels import _build
from fsgm_tpu_torch.utils import tracing


def census(img: torch.Tensor, window) -> torch.Tensor:
    """(..., H, W) integer images on a CUDA device, window (ch, cw) checked
    by the caller -> contiguous (..., H, W) int64 descriptors, one launch
    for every frame."""
    if img.device.type != "cuda":
        raise ValueError(f"census: unsupported device {img.device}")
    if img.dtype not in (torch.uint8, torch.int32):
        img = img.to(torch.int32)
    img = img.contiguous()
    out = torch.empty(img.shape, dtype=torch.int64, device=img.device)
    if out.numel() == 0:
        return out
    h, w = img.shape[-2:]
    fn = _build.load("census")
    with _build.on_device(img):
        err = fn(img.data_ptr(), out.data_ptr(), out.numel() // (h * w), h,
                 w, window[0], window[1], img.element_size(),
                 _build.stream_of(img))
    _build.check(err, "census")
    tracing.launched("census")
    return out
