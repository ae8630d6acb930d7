"""Synthetic stereo and flow pairs with known ground truth (numpy).

The port's own copy of the generators of fsgm_tpu/io/synthetic.py that it
uses: the same seed gives the same arrays in both packages.

* random-dot stereograms with piecewise-constant integer disparity;
* textured pairs moved by a known integer flow (constant, a sliding
  sequence, or a moving block over a static background);
* pairs shifted by a constant non-integer disparity or flow, resampled
  bilinearly from a band-limited texture (the subpixel stage's fixtures).
"""

from __future__ import annotations

import numpy as np


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Dense high-contrast random texture (uint8) — census-friendly."""
    return rng.integers(0, 256, size=(h, w), dtype=np.uint8)


def _box3(img: np.ndarray) -> np.ndarray:
    """3x3 integer box blur with edge-replicate padding."""
    p = np.pad(img.astype(np.int64), 1, mode="edge")
    acc = np.zeros_like(img, dtype=np.int64)
    h, w = img.shape
    for dy in range(3):
        for dx in range(3):
            acc += p[dy: dy + h, dx: dx + w]
    return acc // 9


def _multiscale_texture(rng: np.random.Generator, h: int, w: int
                        ) -> np.ndarray:
    """Texture with energy at several scales (uint8): nearest-upsampled
    noise octaves plus a light blur, so it survives pyramid downsampling."""
    acc = np.zeros((h, w), dtype=np.int64)
    weight_total = 0
    for scale, weight in ((1, 2), (4, 3), (16, 4)):
        hh, ww = max(1, -(-h // scale)), max(1, -(-w // scale))
        noise = rng.integers(0, 256, size=(hh, ww), dtype=np.int64)
        up = np.repeat(np.repeat(noise, scale, axis=0), scale, axis=1)
        acc += weight * up[:h, :w]
        weight_total += weight
    acc = _box3(acc // weight_total)
    return np.clip(acc, 0, 255).astype(np.uint8)


def disparity_layers(h: int, w: int, max_disp: int,
                     rng: np.random.Generator, n_layers: int = 3
                     ) -> np.ndarray:
    """Piecewise-constant disparity: background plane + rectangular layers."""
    disp = np.full((h, w), max(1, max_disp // 8), dtype=np.int64)
    for _ in range(n_layers):
        d = int(rng.integers(1, max(2, max_disp - 2)))
        y0 = int(rng.integers(0, max(1, h - h // 3)))
        x0 = int(rng.integers(0, max(1, w - w // 3)))
        hh = int(rng.integers(h // 6, h // 3 + 1))
        ww = int(rng.integers(w // 6, w // 3 + 1))
        disp[y0: y0 + hh, x0: x0 + ww] = d
    return disp


def random_dot_stereo(h: int, w: int, max_disp: int, seed: int = 0,
                      n_layers: int = 3):
    """Random-dot stereogram with known integer disparity: left(x) =
    right(x - d(x)); pixels with x - d < 0 get fresh texture.

    Returns (img_l, img_r, disp_gt) — uint8, uint8, int64.
    """
    rng = np.random.default_rng(seed)
    img_r = _texture(rng, h, w)
    disp = disparity_layers(h, w, max_disp, rng, n_layers)
    xs = np.arange(w)[None, :].repeat(h, axis=0)
    src_x = xs - disp
    valid = src_x >= 0
    src_x_c = np.clip(src_x, 0, w - 1)
    yy = np.arange(h)[:, None].repeat(w, axis=1)
    img_l = img_r[yy, src_x_c]
    noise = _texture(rng, h, w)
    img_l = np.where(valid, img_l, noise).astype(np.uint8)
    return img_l, img_r, disp


def _bilinear(img: np.ndarray, ys: np.ndarray, xs: np.ndarray
              ) -> np.ndarray:
    """Bilinear sample of a float image at (ys, xs), edge-clamped."""
    h, w = img.shape
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)
    fx = np.clip(xs - x0, 0.0, 1.0)
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def _smooth_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Band-limited float texture: multiscale noise blurred twice, so that
    bilinear resampling at fractional offsets models a continuous image
    (per-pixel noise aliases under subpixel shifts)."""
    t = _multiscale_texture(rng, h, w).astype(np.float64)
    return _box3(_box3(t).astype(np.int64)).astype(np.float64)


def _to_uint8(a: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(a), 0, 255).astype(np.uint8)


def fractional_shift_stereo(h: int, w: int, disp: float, seed: int = 0):
    """Stereo pair with a constant non-integer disparity: left(x) =
    texture(x), right(x) = texture(x + disp), sampled bilinearly, so
    cost(L(x), R(x - d)) is least near d = disp.  Returns (img_l, img_r,
    disp_gt (h, w) float64)."""
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(abs(disp))) + 2
    tex = _smooth_texture(rng, h, w + 2 * pad)
    ys = np.arange(h, dtype=np.float64)[:, None].repeat(w, axis=1)
    xs = np.arange(w, dtype=np.float64)[None, :].repeat(h, axis=0) + pad
    img_l = _bilinear(tex, ys, xs)
    img_r = _bilinear(tex, ys, xs + disp)
    gt = np.full((h, w), disp, dtype=np.float64)
    return _to_uint8(img_l), _to_uint8(img_r), gt


def fractional_flow_pair(h: int, w: int, u: float, v: float, seed: int = 0):
    """Flow pair with constant non-integer motion (u, v): img2 is img1
    resampled bilinearly at p - (u, v), i.e. img2(p + (u, v)) = img1(p),
    the convention of constant_flow_pair.  Returns (img1, img2, flow_gt
    (h, w, 2) float64)."""
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(max(abs(u), abs(v)))) + 2
    tex = _smooth_texture(rng, h + 2 * pad, w + 2 * pad)
    ys = np.arange(h, dtype=np.float64)[:, None].repeat(w, axis=1) + pad
    xs = np.arange(w, dtype=np.float64)[None, :].repeat(h, axis=0) + pad
    img1 = _bilinear(tex, ys, xs)
    img2 = _bilinear(tex, ys - v, xs - u)
    flow = np.zeros((h, w, 2), dtype=np.float64)
    flow[..., 0] = u
    flow[..., 1] = v
    return _to_uint8(img1), _to_uint8(img2), flow


def constant_flow_pair(h: int, w: int, u: int, v: int, seed: int = 0):
    """Image2 is image1 translated by integer (u, v): img2(y + v, x + u) =
    img1(y, x).  Returns (img1, img2, flow_gt (h, w, 2) = (u, v))."""
    rng = np.random.default_rng(seed)
    big = _multiscale_texture(rng, h + 2 * abs(v) + 4, w + 2 * abs(u) + 4)
    oy, ox = abs(v) + 2, abs(u) + 2
    img1 = big[oy: oy + h, ox: ox + w]
    img2 = big[oy - v: oy - v + h, ox - u: ox - u + w]
    flow = np.zeros((h, w, 2), dtype=np.float64)
    flow[..., 0] = u
    flow[..., 1] = v
    return img1.copy(), img2.copy(), flow


def constant_flow_sequence(h: int, w: int, u: int, v: int, n: int,
                           seed: int = 0):
    """N frames sliding over one texture (frame t at offset t*(u, v)), so
    every consecutive pair has constant flow (u, v).  Returns (frames
    (N, h, w) uint8, flow_gt (h, w, 2))."""
    rng = np.random.default_rng(seed)
    big = _multiscale_texture(rng, h + (n - 1) * abs(v) + 4,
                              w + (n - 1) * abs(u) + 4)
    oy = 2 + (n - 1) * max(v, 0)
    ox = 2 + (n - 1) * max(u, 0)
    frames = np.stack([
        big[oy - t * v: oy - t * v + h, ox - t * u: ox - t * u + w]
        for t in range(n)])
    flow = np.zeros((h, w, 2), dtype=np.float64)
    flow[..., 0] = u
    flow[..., 1] = v
    return frames.copy(), flow


def blockwise_flow_pair(h: int, w: int, max_mag: int, seed: int = 0):
    """A rectangle moving by a random integer (u, v), |u|, |v| <= max_mag,
    over a static background.

    Returns (img1, img2, flow_gt, valid_mask); background pixels covered
    by the moved block are marked invalid in the mask.
    """
    rng = np.random.default_rng(seed)
    img1 = _multiscale_texture(rng, h, w)
    u = int(rng.integers(-max_mag, max_mag + 1))
    v = int(rng.integers(-max_mag, max_mag + 1))
    y0, x0 = h // 4, w // 4
    hh, ww = h // 2, w // 2
    flow = np.zeros((h, w, 2), dtype=np.float64)
    flow[y0: y0 + hh, x0: x0 + ww, 0] = u
    flow[y0: y0 + hh, x0: x0 + ww, 1] = v
    img2 = img1.copy()
    ys, xs = np.meshgrid(np.arange(y0, y0 + hh), np.arange(x0, x0 + ww),
                         indexing="ij")
    ty, tx = ys + v, xs + u
    ok = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
    img2[ty[ok], tx[ok]] = img1[ys[ok], xs[ok]]
    valid = np.ones((h, w), dtype=bool)
    covered = np.zeros((h, w), dtype=bool)
    covered[ty[ok], tx[ok]] = True
    covered[y0: y0 + hh, x0: x0 + ww] = False
    valid &= ~covered
    return img1, img2, flow, valid
