"""K3 extract_stereo: WTA, subpixel neighbourhood, right-view WTA and LR
validity in one pass over S.

Replaces fsgm_tpu/ops/pallas/extract_tr.py::extract_stereo_major as the main
path calls it (with_sub, with_rwta, with_lr).  From the label-minor
(H, W, D) S it returns five (H, W) int32 planes:

    d_int          argmin_d S, smallest d on ties
    s_m, s_0, s_p  S[d*-1], S[d*], S[d*+1] (BIG = 1 << 24 out of range)
    valid          1 where |dr - rho(x - dr)| <= max_diff and x >= dr,
                   dr = rint(subpixel d*) (d* without subpixel) and rho the
                   right-view WTA argmin_d S(y, x+d, d), s_invalid past W

``extract_stereo`` launches the CUDA kernel (csrc/extract.cu) for CUDA
tensors and takes ``extract_stereo_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.kernels import _build

MAX_WIDTH = 232448 // 8  # two int32 rows of shared memory per block


def extract_stereo_plain(s: torch.Tensor, s_invalid: int, max_diff: int = 1,
                         with_sub: bool = True):
    """Plain PyTorch version: packed-min WTA, one-hot neighbourhood and the
    index-arithmetic diagonal gather of ops/extract.py."""
    nd = s.shape[-1]
    d_int = ext.wta(s)
    s_m, s_0, s_p = ext.neighborhood_of_min(s, d_int)
    disp = (ext.subpixel_from_neighborhood(d_int, s_m, s_0, s_p, nd)
            if with_sub else d_int.to(torch.float32))
    valid = ext.lr_valid(disp, ext.wta_right_from_s(s, s_invalid), max_diff)
    return d_int, s_m, s_0, s_p, valid.to(torch.int32)


def extract_stereo(s: torch.Tensor, s_invalid: int, max_diff: int = 1,
                   with_sub: bool = True):
    """(H, W, D) int16/int32 S -> (d_int, s_m, s_0, s_p, valid), each
    (H, W) int32."""
    if s.dtype not in (torch.int16, torch.int32) or s.dim() != 3:
        raise TypeError("extract_stereo takes an (H, W, D) int16/int32 S")
    h, w, nd = s.shape
    if not 0 < nd <= 256 or not 0 <= s_invalid < (1 << 22):
        raise ValueError("extract_stereo packs (S << 8) | d: needs D <= 256 "
                         "and s_invalid < 2^22")
    if s.device.type == "cpu":
        return extract_stereo_plain(s, s_invalid, max_diff, with_sub)
    if s.device.type != "cuda":
        raise ValueError(f"extract_stereo: unsupported device {s.device}")
    if nd % 32 != 0 or w > MAX_WIDTH or not s.is_contiguous():
        raise ValueError(f"extract_stereo kernel needs a contiguous S with D "
                         f"a multiple of 32 and W <= {MAX_WIDTH}, got "
                         f"{tuple(s.shape)}")
    outs = [torch.empty((h, w), dtype=torch.int32, device=s.device)
            for _ in range(5)]
    if s.numel() == 0:
        return tuple(outs)
    fn = _build.load("extract")
    with torch.cuda.device(s.device):
        err = fn(s.data_ptr(), int(s.dtype == torch.int32),
                 *(o.data_ptr() for o in outs), h, w, nd, s_invalid,
                 max_diff, int(with_sub), _build.stream_of(s))
    _build.check(err, "extract_stereo")
    _build.LAUNCHES["extract_stereo"] += 1
    return tuple(outs)
