"""KITTI devkit disparity / flow PNG readers and writers and the
Middlebury .flo reader and writer.

The port's own copy of the codecs of fsgm_tpu/io/kitti.py: the writers
write byte for byte the same files, the readers return the same arrays:
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


def read_disparity_png(path) -> np.ndarray:
    """(H, W) float32 disparity; invalid pixels = -1."""
    raw = read_png16(path).astype(np.float32)
    disp = raw / 256.0
    disp[raw == 0] = -1.0
    return disp


def read_flow_png(path):
    """((H, W, 2) float32 flow, (H, W) bool valid); flow 0 where invalid."""
    raw = read_png16(path).astype(np.float64)
    if raw.ndim != 3 or raw.shape[2] < 3:
        raise ValueError("KITTI flow PNG must have 3 channels")
    valid = raw[..., 2] > 0
    u = (raw[..., 0] - 2 ** 15) / 64.0
    v = (raw[..., 1] - 2 ** 15) / 64.0
    flow = np.stack([u, v], axis=-1).astype(np.float32)
    flow[~valid] = 0.0
    return flow, valid


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


def read_png16(path) -> np.ndarray:
    """PNG decoder for 8/16-bit grayscale / RGB, every filter type, no
    interlace (PIL truncates 48-bit RGB, the KITTI flow encoding, to 8 bits
    a channel).  (H, W) or (H, W, C) at the file's bit depth."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG: {path}")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if ihdr is None:
        raise ValueError(f"PNG without IHDR: {path}")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNG not supported")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    bpp = channels * (depth // 8)          # bytes per pixel
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    out = np.empty((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride,
                             y * (stride + 1) + 1).copy()
        if ftype == 0:
            cur = line
        elif ftype == 2:                   # Up
            cur = line + prev
        elif ftype in (1, 3, 4):           # Sub / Average / Paeth: sequential
            cur = line.astype(np.int32)
            pv = prev.astype(np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = pv[i]
                c = pv[i - bpp] if i >= bpp else 0
                if ftype == 1:
                    cur[i] = (cur[i] + a) & 0xFF
                elif ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = cur
        prev = out[y]
    if depth == 16:
        arr = out.reshape(h, w, channels, 2).astype(np.uint16)
        arr = (arr[..., 0] << 8) | arr[..., 1]
    else:
        arr = out.reshape(h, w, channels).astype(np.uint16)
    return arr[..., 0] if channels == 1 else arr


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


def read_flo(path) -> np.ndarray:
    """(H, W, 2) float32 flow of a .flo file; ValueError on a bad magic."""
    with open(path, "rb") as f:
        magic = struct.unpack("<f", f.read(4))[0]
        if abs(magic - FLO_MAGIC) > 1e-3:
            raise ValueError(f"bad .flo magic {magic} in {path}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(), dtype="<f4", count=h * w * 2)
    return data.reshape(h, w, 2).copy()


def write_flo(path, flow: np.ndarray) -> None:
    flow = np.asarray(flow, dtype=np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<f", FLO_MAGIC))
        f.write(struct.pack("<ii", w, h))
        f.write(flow.astype("<f4").tobytes())
