"""min16_probe: is an elementwise int16 minimum exact, and what does it gain
over int32, on the card.

Replaces the TPU probe tools/tr_int16_probe.py::_min_matrix (does Mosaic
legalise an int16 min of two (64, 256) arrays written as minsi, as a
select, or widened to int32).  The CUDA kernel (csrc/min16_probe.cu) takes
the same three formulations plus ``packed``, two int16 minima per 32-bit
word by __vmins2, and ``int32``, the int32 minimum as the baseline.  Its
plain version and library call is torch.minimum.  Only chip_smoke.py
drives it: the answer is input to the redesign of K2, whose S is int16
where plan_dtypes allows.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.ops.kernels import _build
from fsgm_tpu_torch.utils import tracing

FORMS = ("minsi", "select", "widen", "packed", "int32")
_FORM_INDEX = {form: k for k, form in enumerate(FORMS)}
VECTOR_BYTES = 16  # csrc/min16_probe.cu kVector: bytes a thread moves a step


def min_probe_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: torch.minimum."""
    return torch.minimum(a, b)


def _output_like(a: torch.Tensor) -> torch.Tensor:
    """An empty tensor of a's shape and type at a's offset from a 16-byte
    boundary, so that the kernel's 16-byte body covers a, b and out alike
    (a fresh allocation sits on a boundary)."""
    off = a.data_ptr() % VECTOR_BYTES
    if off == 0:
        return torch.empty_like(a)
    k = off // a.element_size()
    flat = torch.empty(a.numel() + VECTOR_BYTES // a.element_size(),
                       dtype=a.dtype, device=a.device)
    return flat[k:k + a.numel()].view(a.shape)


def min_probe(a: torch.Tensor, b: torch.Tensor, form: str) -> torch.Tensor:
    """Elementwise min of two int16 tensors (int32 for form "int32") of
    one shape, by the kernel's formulation ``form`` (FORMS).  Any count of
    values and any element offset; the packed form takes an even count
    with every tensor aligned to 4 bytes."""
    code = _FORM_INDEX.get(form)
    if code is None:
        raise ValueError(f"form {form!r} is not one of {FORMS}")
    dtype = torch.int32 if form == "int32" else torch.int16
    if a.dtype != dtype or b.dtype != dtype or a.shape != b.shape:
        raise TypeError(f"form {form} takes two {dtype} tensors of one "
                        f"shape, got {a.dtype} {tuple(a.shape)} and "
                        f"{b.dtype} {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("min_probe inputs lie on different devices")
    n = a.numel()
    if form == "packed" and (n % 2 or (a.data_ptr() | b.data_ptr()) % 4):
        raise ValueError("the packed form needs an even count of values "
                         "aligned to 4 bytes")
    if a.device.type == "cpu":
        return min_probe_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"min_probe: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("min_probe takes contiguous tensors")
    out = _output_like(a)
    if n > 0:
        fn = _build.load("min16_probe")
        with _build.on_device(a):
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, code,
                     _build.stream_of(a))
        _build.check(err, "min16_probe")
        tracing.launched("min16_probe")
    return out
