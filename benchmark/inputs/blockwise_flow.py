"""Traffic generator "blockwise_flow": a textured frame and the same frame
with its central block (half the height and width) moved by a random
integer (u, v), |u|, |v| <= max_mag, over the static background; made on
the device.

The construction of fsgm_tpu_torch/io/synthetic.py::blockwise_flow_pair,
frozen here and drawn for a whole pool at once from one torch.Generator:
the texture is noise at scales 1, 4 and 16 (weights 2, 3, 4, each octave
upsampled by nearest neighbour) and a 3x3 box blur, so that it survives
the flow pyramid's downsampling.
"""

from __future__ import annotations

import torch


def _box3(img: torch.Tensor) -> torch.Tensor:
    """3x3 integer box mean of (N, H, W), the edge repeated outward."""
    h, w = img.shape[-2:]
    rows = torch.arange(-1, h + 1, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=img.device).clamp(0, w - 1)
    p = img.index_select(-2, rows).index_select(-1, cols)
    return sum(p[..., dy:dy + h, dx:dx + w]
               for dy in range(3) for dx in range(3)) // 9


def texture(frames: int, h: int, w: int, gen: torch.Generator
            ) -> torch.Tensor:
    acc = torch.zeros((frames, h, w), dtype=torch.int64, device=gen.device)
    for scale, weight in ((1, 2), (4, 3), (16, 4)):
        noise = torch.randint(0, 256, (frames, -(-h // scale), -(-w // scale)),
                              generator=gen, device=gen.device)
        up = noise.repeat_interleave(scale, 1).repeat_interleave(scale, 2)
        acc += weight * up[:, :h, :w]
    return _box3(acc // 9).clamp(0, 255).to(torch.uint8)


def make(frames: int, cfg: dict, gen: torch.Generator, max_mag: int = 8):
    """(img1, img2, (u, v)): (frames, H, W) uint8 twice and the block's
    motion, (frames, 2) int64, on the generator's device."""
    h, w = cfg["height"], cfg["width"]
    dev = gen.device
    img1 = texture(frames, h, w, gen)
    uv = torch.randint(-max_mag, max_mag + 1, (frames, 2), generator=gen,
                       device=dev)
    u, v = uv[:, 0, None, None], uv[:, 1, None, None]
    y0, x0, hh, ww = h // 4, w // 4, h // 2, w // 2
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    # pixel (y, x) of img2 shows img1(y - v, x - u) where that lies in the
    # moved block, else the background img1(y, x)
    sy, sx = ys - v, xs - u
    moved = (sy >= y0) & (sy < y0 + hh) & (sx >= x0) & (sx < x0 + ww)
    src = (torch.arange(frames, device=dev)[:, None, None] * (h * w)
           + torch.where(moved, sy * w + sx, ys * w + xs))
    return img1, img1.reshape(-1)[src], uv
