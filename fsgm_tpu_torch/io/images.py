"""Grayscale image reading and writing, and PFM writing (numpy).

The port's own copy of the parts of fsgm_tpu/io/images.py it uses: PIL
reads and writes PNG et al.; PFM (Middlebury float maps) is written
directly.
"""

from __future__ import annotations

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
