"""Traffic generator "random_dot_stereo": rectified random-dot pairs with
a layered, piecewise-constant integer disparity, made on the device.

The construction of fsgm_tpu_torch/io/synthetic.py::random_dot_stereo,
frozen here and drawn for a whole pool at once from one torch.Generator:
the right image is uniform noise; the disparity is a background plane of
max_disp // 8 with ``n_layers`` rectangles of random disparity in [1,
max_disp - 2) pasted over it; left(y, x) = right(y, x - d(y, x)), fresh
noise where x - d < 0.
"""

from __future__ import annotations

import torch


def make(frames: int, cfg: dict, gen: torch.Generator, n_layers: int = 3):
    """(left, right, disparity): (frames, H, W) uint8, uint8, int64 on
    the generator's device."""
    h, w = cfg["height"], cfg["width"]
    max_disp = cfg["params"]["max_disp"]
    dev = gen.device

    def draw(lo: int, hi: int, shape=(frames, 1, 1)):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    right = draw(0, 256, (frames, h, w)).to(torch.uint8)
    disp = torch.full((frames, h, w), max(1, max_disp // 8),
                      dtype=torch.int64, device=dev)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    for _ in range(n_layers):
        d = draw(1, max(2, max_disp - 2))
        y0 = draw(0, max(1, h - h // 3))
        x0 = draw(0, max(1, w - w // 3))
        hh = draw(h // 6, h // 3 + 1)
        ww = draw(w // 6, w // 3 + 1)
        inside = (ys >= y0) & (ys < y0 + hh) & (xs >= x0) & (xs < x0 + ww)
        disp = torch.where(inside, d, disp)
    src = xs - disp
    left = torch.gather(right, -1, src.clamp(0, w - 1))
    noise = draw(0, 256, (frames, h, w)).to(torch.uint8)
    return torch.where(src >= 0, left, noise), right, disp
