"""Grayscale image reading and writing, PGM and PFM (numpy).

The port's own copy of fsgm_tpu/io/images.py: PIL reads and writes PNG et
al.; PGM (P2 and P5, the classic stereo-pair format) and PFM (Middlebury
float maps) are header + raster formats read and written directly.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np


def load_gray(path) -> np.ndarray:
    """Load any PIL-readable image as (H, W) uint8 grayscale."""
    from PIL import Image
    img = Image.open(path)
    if img.mode not in ("L", "I;16", "I"):
        img = img.convert("L")
    arr = np.asarray(img)
    if arr.dtype == np.uint16:
        arr = (arr >> 8).astype(np.uint8)
    elif arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


def save_gray(path, img: np.ndarray) -> None:
    """(H, W) uint8 image to any PIL-writable file (PNG by suffix)."""
    from PIL import Image
    Image.fromarray(np.asarray(img, dtype=np.uint8), mode="L").save(path)


def read_pgm(path) -> np.ndarray:
    """P2 (ASCII) or P5 (binary) PGM as (H, W) uint8; a maxval of 256 or
    more (16-bit samples, big-endian in P5) is rescaled by * 255 // maxval."""
    data = Path(path).read_bytes()
    m = re.match(rb"^(P[25])\s+(?:#.*\s+)*(\d+)\s+(\d+)\s+(\d+)\s", data)
    if not m:
        raise ValueError(f"not a PGM file: {path}")
    magic, w, h, maxval = (m.group(1), int(m.group(2)), int(m.group(3)),
                           int(m.group(4)))
    off = m.end()
    if magic == b"P5":
        dt = np.uint8 if maxval < 256 else np.dtype(">u2")
        arr = np.frombuffer(data, dtype=dt, count=h * w, offset=off)
    else:
        arr = np.array(data[off:].split()[:h * w], dtype=np.int64)
    arr = arr.reshape(h, w)
    if maxval >= 256:
        arr = arr.astype(np.int64) * 255 // maxval
    return arr.astype(np.uint8)


def write_pgm(path, img: np.ndarray) -> None:
    """(H, W) uint8 image as binary PGM (P5, maxval 255)."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def read_pfm(path) -> np.ndarray:
    """PFM as (H, W) ("Pf") or (H, W, 3) ("PF") float32, top row first; the
    scale's sign gives the byte order (negative: little-endian)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"Pf", b"PF"):
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        endian = "<" if float(f.readline().strip()) < 0 else ">"
        n_chan = 3 if magic == b"PF" else 1
        data = np.frombuffer(f.read(), dtype=endian + "f4",
                             count=h * w * n_chan)
    shape = (h, w, 3) if n_chan == 3 else (h, w)
    return data.reshape(shape)[::-1].astype(np.float32)  # stored bottom-up


def write_pfm(path, data: np.ndarray) -> None:
    """(H, W) or (H, W, 3) float map as little-endian PFM (bottom-up)."""
    data = np.asarray(data, dtype=np.float32)
    magic = b"PF" if data.ndim == 3 else b"Pf"
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(magic + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(data[::-1].tobytes())
