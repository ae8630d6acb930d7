"""K3 extract_stereo and K4 extract_flow: the extraction passes over S.

K3 replaces fsgm_tpu/ops/pallas/extract_tr.py::extract_stereo_major as the
stereo paths call it (with_sub, and with_rwta + with_lr unless the LR check
is off or lr_mode="reagg" brings its own right view).  From the label-minor
(H, W, D) S of one frame, or (B, H, W, D) of B frames in one launch, it
returns five int32 planes of S's leading shape:

    d_int          argmin_d S, smallest d on ties
    s_m, s_0, s_p  S[d*-1], S[d*], S[d*+1] (BIG = 1 << 24 out of range)
    valid          1 where |dr - rho(x - dr)| <= max_diff and x >= dr,
                   dr = rint(subpixel d*) (d* without subpixel) and rho the
                   right-view WTA argmin_d S(y, x+d, d), s_invalid past W;
                   None without with_rwta

Without with_rwta, K3 also replaces fsgm_tpu/ops/pallas/extract_pallas.py::
wta_neighborhood (d*, S[d*-1], S[d*], S[d*+1] of the label-minor S, the
first pass of the JAX package's FSGM_EXTRACT=minor extraction; the port's
right-reference pass of lr_mode="reagg" runs K3 so).  One convention differs at label edges:
wta_neighborhood returns s_m = 0 where d* = 0 and s_p = 0 where d* = D-1,
K3 returns BIG there; callers read s_m / s_p only on the interior.

``wta_right`` (K3's right-view pass, csrc/extract.cu) replaces fsgm_tpu/
ops/pallas/extract_tr.py::wta_right_major: the (B, H, W) int32 right-view
WTA rho alone from one read of S.  No path of the port calls it: the JAX
package's FSGM_EXTRACT=minor extraction, which runs wta_right_major, gives
the same disparity as K3's one pass with its right view and LR check and
is slower on the card, so the port keeps K3's one pass (PERF.md).

For column tiling (fsgm_tpu_torch/parallel/tiled.py) S may be a window
whose column x sits at the global column gx0 + x of an image w_global
wide: rho then also needs gx0 + x + d < w_global, and valid x - dr >=
max(0, -gx0) (ops/extract.py::wta_right_from_s, ::lr_valid).

K4 replaces fsgm_tpu/ops/pallas/extract_tr.py::extract_flow_major.  From
the label-minor flow S, whose first nl = e * e slots are the (e x e) label
grid, it returns l_int = argmin_l S (smallest l on ties) and, with
subpixel, the u and v triples of S at the clipped neighbour labels that
models/flow.py::subpixel_flow feeds to its parabola.  S may carry a
frame axis, (N, H, W, D): one launch walks its N * H * W pixels.

``extract_stereo`` / ``extract_flow`` launch the CUDA kernels
(csrc/extract.cu, csrc/extract_flow.cu) for CUDA tensors and take the
``*_plain`` versions for CPU tensors.
"""

from __future__ import annotations

import torch

from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.kernels import _build
from fsgm_tpu_torch.utils import tracing

# csrc/extract.cu: a block's shared memory holds its ring of S pixels and
# int32 planes of the row, each of stride at most W + 1 (rho, d*, s_0, s_m,
# s_p; wta_right rho alone)
SMEM_BYTES = 232448  # kSmemBytes: an H100 block's shared memory, at most
RING_BYTES = 32768   # kRingBytes
PLANES = 5           # kPlanes
MAX_WIDTH = (SMEM_BYTES - RING_BYTES) // (4 * PLANES) - 1
MAX_WIDTH_RIGHT = (SMEM_BYTES - RING_BYTES) // 4 - 1

# csrc/extract_flow.cu reads S in 16-byte chunks (kChunk); its entry takes
# the row count N * H as an int
K4_CHUNK = 16
MAX_ROWS = (1 << 31) - 1


def _w_global(w: int, gx0: int, w_global: int | None) -> int:
    """w_global, checked (default: the untiled frame, W)."""
    w_global = w if w_global is None else w_global
    if w_global < 1 or not -(1 << 30) < gx0 < (1 << 30):
        raise ValueError(f"window gx0 {gx0}, w_global {w_global}")
    return w_global


def _check_s(s: torch.Tensor, s_invalid: int, name: str) -> None:
    if s.dtype not in (torch.int16, torch.int32) or s.dim() not in (3, 4):
        raise TypeError(f"{name} takes an (H, W, D) or (B, H, W, D) "
                        f"int16/int32 S")
    if not 0 < s.shape[-1] <= 256 or not 0 <= s_invalid < (1 << 22):
        raise ValueError(f"{name} packs (S << 8) | d: needs D <= 256 and "
                         f"s_invalid < 2^22")


def extract_stereo_plain(s: torch.Tensor, s_invalid: int, max_diff: int = 1,
                         with_sub: bool = True, with_rwta: bool = True,
                         gx0: int = 0, w_global: int | None = None):
    """Plain PyTorch version: packed-min WTA, one-hot neighbourhood and the
    index-arithmetic diagonal gather of ops/extract.py."""
    nd = s.shape[-1]
    w_global = _w_global(s.shape[-2], gx0, w_global)
    d_int = ext.wta(s)
    s_m, s_0, s_p = ext.neighborhood_of_min(s, d_int)
    if not with_rwta:
        return d_int, s_m, s_0, s_p, None
    disp = (ext.subpixel_from_neighborhood(d_int, s_m, s_0, s_p, nd)
            if with_sub else d_int.to(torch.float32))
    valid = ext.lr_valid(disp, ext.wta_right_from_s(s, s_invalid, gx0,
                                                    w_global),
                         max_diff, nd, x_lo=max(0, -gx0))
    return d_int, s_m, s_0, s_p, valid.to(torch.int32)


def extract_stereo(s: torch.Tensor, s_invalid: int, max_diff: int = 1,
                   with_sub: bool = True, with_rwta: bool = True,
                   gx0: int = 0, w_global: int | None = None):
    """(H, W, D) or (B, H, W, D) int16/int32 S -> (d_int, s_m, s_0, s_p,
    valid), each int32 of S's leading shape (valid None without
    with_rwta); gx0 / w_global place S's columns in a wider image (module
    docstring).  One kernel launch covers all B frames."""
    _check_s(s, s_invalid, "extract_stereo")
    h, w, nd = s.shape[-3:]
    w_global = _w_global(w, gx0, w_global)
    if s.device.type == "cpu":
        return extract_stereo_plain(s, s_invalid, max_diff, with_sub,
                                    with_rwta, gx0, w_global)
    if s.device.type != "cuda":
        raise ValueError(f"extract_stereo: unsupported device {s.device}")
    if (nd % 32 != 0 or w > MAX_WIDTH or not s.is_contiguous()
            or s.data_ptr() % 16):
        raise ValueError(f"extract_stereo kernel needs a contiguous, 16-byte "
                         f"aligned S with D a multiple of 32 and W <= "
                         f"{MAX_WIDTH}, got {tuple(s.shape)}")
    # one allocation for the planes (a launch's host time counts at B = 1)
    outs = torch.empty((5 if with_rwta else 4,) + s.shape[:-1],
                       dtype=torch.int32, device=s.device).unbind(0)
    if s.numel() > 0:
        ptrs = [o.data_ptr() for o in outs]
        ptrs += [ptrs[0]] * (5 - len(ptrs))  # never written without rwta
        b = s.shape[0] if s.dim() == 4 else 1
        fn = _build.load("extract_stereo")
        with _build.on_device(s):
            err = fn(s.data_ptr(), int(s.dtype == torch.int32), *ptrs, b, h,
                     w, nd, s_invalid, max_diff, int(with_sub),
                     int(with_rwta), gx0, w_global, _build.stream_of(s))
        _build.check(err, "extract_stereo")
        tracing.launched("extract_stereo")
    return tuple(outs) + (() if with_rwta else (None,))


def wta_right_plain(s: torch.Tensor, s_invalid: int) -> torch.Tensor:
    """Plain PyTorch version: ops/extract.py's index-arithmetic diagonal
    gather, wta_right_from_s."""
    return ext.wta_right_from_s(s, s_invalid)


def wta_right(s: torch.Tensor, s_invalid: int) -> torch.Tensor:
    """(H, W, D) or (B, H, W, D) int16/int32 S -> int32 rho of S's leading
    shape: argmin_d S(y, x + d, d), s_invalid where x + d >= W, smallest d
    on ties.  One kernel launch covers all B frames."""
    _check_s(s, s_invalid, "wta_right")
    h, w, nd = s.shape[-3:]
    if s.device.type == "cpu":
        return wta_right_plain(s, s_invalid)
    if s.device.type != "cuda":
        raise ValueError(f"wta_right: unsupported device {s.device}")
    if (nd % 32 != 0 or w > MAX_WIDTH_RIGHT or not s.is_contiguous()
            or s.data_ptr() % 16):
        raise ValueError(f"wta_right kernel needs a contiguous, 16-byte "
                         f"aligned S with D a multiple of 32 and W <= "
                         f"{MAX_WIDTH_RIGHT}, got {tuple(s.shape)}")
    rho = torch.empty(s.shape[:-1], dtype=torch.int32, device=s.device)
    if s.numel() > 0:
        b = s.shape[0] if s.dim() == 4 else 1
        fn = _build.load("wta_right")
        with _build.on_device(s):
            err = fn(s.data_ptr(), int(s.dtype == torch.int32),
                     rho.data_ptr(), b, h, w, nd, s_invalid,
                     _build.stream_of(s))
        _build.check(err, "wta_right")
        tracing.launched("wta_right")
    return rho


def extract_flow_plain(s: torch.Tensor, nl: int, label_ext: int,
                       with_sub: bool = True):
    """Plain PyTorch version: packed-min WTA over the first nl labels, then
    one gather of the six clipped neighbour labels."""
    e = label_ext
    sv = s[..., :nl].to(torch.int32)
    l_int = ext.wta(sv)
    if not with_sub:
        return l_int, None, None
    iv = l_int // e
    iu = l_int - iv * e
    bu = iv * e + iu.clamp(1, e - 2)
    bv = iv.clamp(1, e - 2) * e + iu
    idx = torch.stack([bu - 1, bu, bu + 1, bv - e, bv, bv + e], dim=-1)
    vals = torch.gather(sv, -1, idx.to(torch.int64)).unbind(-1)
    return l_int, vals[:3], vals[3:]


def check_flow_kernel_input(s: torch.Tensor) -> None:
    """Raise unless the kernel takes S: contiguous, 16-byte aligned, D a
    multiple of 32 up to 256."""
    nd = s.shape[-1]
    if (nd % 32 != 0 or nd > 256 or not s.is_contiguous()
            or s.data_ptr() % K4_CHUNK):
        raise ValueError(f"extract_flow kernel needs a contiguous, 16-byte "
                         f"aligned S with D a multiple of 32 up to 256, got "
                         f"{tuple(s.shape)}")


def extract_flow(s: torch.Tensor, nl: int, label_ext: int,
                 with_sub: bool = True):
    """([N,] H, W, D) int16/int32 flow S with nl = label_ext^2 real labels
    -> (l_int, (u_m, u_0, u_p), (v_m, v_0, v_p)), each ([N,] H, W) int32;
    the triples are None without with_sub.  One launch for all N frames:
    the kernel walks the N * H * W pixels as one flat run."""
    if s.dtype not in (torch.int16, torch.int32) or s.dim() not in (3, 4):
        raise TypeError("extract_flow takes an (H, W, D) or (N, H, W, D) "
                        "int16/int32 S")
    w, nd = s.shape[-2:]
    rows = s.shape[:-2].numel()  # N * H
    if label_ext < 3 or nl != label_ext ** 2 or nl > min(nd, 255):
        raise ValueError(f"extract_flow needs label_ext >= 3 and nl = "
                         f"label_ext^2 <= min(D, 255), got label_ext "
                         f"{label_ext}, nl {nl}, D {nd}")
    if s.device.type == "cpu":
        return extract_flow_plain(s, nl, label_ext, with_sub)
    if s.device.type != "cuda":
        raise ValueError(f"extract_flow: unsupported device {s.device}")
    check_flow_kernel_input(s)
    if rows > MAX_ROWS:
        raise ValueError(f"extract_flow kernel takes fewer than 2^31 rows "
                         f"N * H, got {rows}")
    # one allocation for the planes (a launch's host time counts at a frame)
    outs = torch.empty((7 if with_sub else 1,) + s.shape[:-1],
                       dtype=torch.int32, device=s.device).unbind(0)
    if s.numel() > 0:
        ptrs = [o.data_ptr() for o in outs]
        ptrs += [ptrs[0]] * (7 - len(ptrs))  # never written without with_sub
        fn = _build.load("extract_flow")
        with _build.on_device(s):
            err = fn(s.data_ptr(), int(s.dtype == torch.int32), *ptrs, rows,
                     w, nd, nl, label_ext, int(with_sub), _build.stream_of(s))
        _build.check(err, "extract_flow")
        tracing.launched("extract_flow")
    if not with_sub:
        return outs[0], None, None
    return outs[0], tuple(outs[1:4]), tuple(outs[4:7])
