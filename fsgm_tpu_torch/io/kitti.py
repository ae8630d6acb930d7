"""KITTI devkit disparity / flow PNG writers and the Middlebury .flo writer.

The port's own copy of the writers of fsgm_tpu/io/kitti.py, byte for byte
the same files:
  * disparity PNG: uint16, value = disp * 256; 0 = invalid;
  * flow PNG: 3-channel uint16; u = (ch0 - 2^15) / 64, v = (ch1 - 2^15) / 64,
    ch2 = validity (1 = valid);
  * .flo: magic float 202021.25, int32 width, height, interleaved f32 (u, v).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

FLO_MAGIC = 202021.25


def write_disparity_png(path, disp: np.ndarray) -> None:
    """disp: (H, W) float; invalid (<0) stored as 0."""
    d = np.asarray(disp, dtype=np.float64)
    raw = np.where(d >= 0, np.clip(d * 256.0 + 0.5, 1, 65535), 0)
    write_png16(path, raw.astype(np.uint16)[..., None])


def write_flow_png(path, flow: np.ndarray, valid: np.ndarray | None = None
                   ) -> None:
    """(H, W, 2) flow and its (H, W) validity plane (all valid if None: a
    flow value is never an invalidity sentinel)."""
    h, w = flow.shape[:2]
    if valid is None:
        valid = np.ones((h, w), dtype=bool)
    raw = np.zeros((h, w, 3), dtype=np.uint16)
    raw[..., 0] = np.clip(flow[..., 0] * 64.0 + 2 ** 15, 0, 65535)
    raw[..., 1] = np.clip(flow[..., 1] * 64.0 + 2 ** 15, 0, 65535)
    raw[..., 2] = valid.astype(np.uint16)
    write_png16(path, raw)


def write_png16(path, arr: np.ndarray) -> None:
    """(H, W, 1 or 3) uint16 as a 16-bit grayscale / RGB PNG, written
    directly (zlib + minimal chunks): PIL's 16-bit multi-channel support
    is unreliable."""
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2}[c]
    be = arr.astype(">u2")
    raw = b"".join(b"\x00" + be[i].tobytes() for i in range(h))

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body + \
            struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 16, color_type, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def write_flo(path, flow: np.ndarray) -> None:
    flow = np.asarray(flow, dtype=np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<f", FLO_MAGIC))
        f.write(struct.pack("<ii", w, h))
        f.write(flow.astype("<f4").tobytes())
