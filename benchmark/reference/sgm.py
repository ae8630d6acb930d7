"""Plain PyTorch building blocks of the benchmark's reference: census, the
SGM path recurrence, winner-take-all and the 3x3 median.

Written for the benchmark from the published method (Hirschmueller, PAMI
2008; census after Zabih and Woodfill, ECCV 1994) in the integer form of
configs 2, 3 and 4, and imports nothing of the program under test: the
comparison that decides a run's ``correct`` holds the program to these
functions.  Every function takes leading frame axes and treats each frame
on its own; every integer stage is exact, so the program's output has to
equal the reference's bit for bit.

``control`` names a deliberately lowered precision (``CONTROLS``): the
step a later change might be tempted to take.  The reference computed
with it has to come out as not correct (benchmark/control.py reads it).
"""

from __future__ import annotations

import torch

# out-of-range label neighbour: INF + P2 + the largest cost fits int32
INF = 1 << 30
# out-of-range neighbour of the winning label (callers gate on interior)
BIG = 1 << 24

# the 8 path directions (dy, dx): the predecessor of p on path r is p - r
DIRS_8 = ((0, 1), (0, -1), (1, 0), (-1, 0),
          (1, 1), (1, -1), (-1, 1), (-1, -1))
# the 16 of Hirschmueller's paper: the 8 and the knight moves
DIRS_16 = DIRS_8 + ((1, 2), (1, -2), (-1, 2), (-1, -2),
                    (2, 1), (2, -1), (-2, 1), (-2, -1))

# lowered precisions the controls compute in:
#   cost_int4      - matching costs held in 4 bits (saturated at 15) where
#                    the configuration states 8;
#   subpixel_bf16  - the parabola's float32 arithmetic in bfloat16
CONTROLS = ("cost_int4", "subpixel_bf16")


def check_control(control: str | None) -> None:
    if control is not None and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}; one of {CONTROLS}")


def census(img: torch.Tensor, window=(5, 5)) -> torch.Tensor:
    """(..., H, W) uint8 -> (..., H, W) int64 descriptors: bit k set where
    the k-th neighbour of the window (row-major, centre skipped) is darker
    than the centre; the image's edge rows and columns repeat outward."""
    ch, cw = window
    ry, rx = ch // 2, cw // 2
    h, w = img.shape[-2:]
    centre = img.to(torch.int32)
    rows = torch.arange(-ry, h + ry, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-rx, w + rx, device=img.device).clamp(0, w - 1)
    padded = centre.index_select(-2, rows).index_select(-1, cols)
    out = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    bit = 0
    for oy in range(ch):
        for ox in range(cw):
            if (oy, ox) == (ry, rx):
                continue
            out |= (padded[..., oy:oy + h, ox:ox + w] < centre
                    ).to(torch.int64) << bit
            bit += 1
    return out


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bits that differ between non-negative int64 words, as int32."""
    x = a ^ b
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return (x & 0x7F).to(torch.int32)


def lower_cost(cost: torch.Tensor, control: str | None) -> torch.Tensor:
    """The matching cost as the control holds it."""
    return cost.clamp(max=15) if control == "cost_int4" else cost


def _neighbour_min(prev: torch.Tensor, label_ext: int | None
                   ) -> torch.Tensor:
    """min of each label's neighbours in (..., nl) int32, INF where a
    neighbour does not exist: l - 1 and l + 1 for disparities, the four
    neighbours of the (label_ext x label_ext) grid for flow vectors."""
    if label_ext is None:
        inf = torch.full_like(prev[..., :1], INF)
        return torch.minimum(torch.cat([inf, prev[..., :-1]], dim=-1),
                             torch.cat([prev[..., 1:], inf], dim=-1))
    e = label_ext
    g = prev.reshape(prev.shape[:-1] + (e, e))
    inf_row = torch.full_like(g[..., :1, :], INF)
    inf_col = torch.full_like(g[..., :, :1], INF)
    m = torch.minimum(
        torch.minimum(torch.cat([inf_row, g[..., :-1, :]], dim=-2),
                      torch.cat([g[..., 1:, :], inf_row], dim=-2)),
        torch.minimum(torch.cat([inf_col, g[..., :, :-1]], dim=-1),
                      torch.cat([g[..., :, 1:], inf_col], dim=-1)))
    return m.reshape(prev.shape)


def inside(n: int, d: int) -> tuple[slice, slice]:
    """Along an axis of n: the positions q whose q - d lies inside, and
    those q - d."""
    return slice(max(d, 0), n + min(d, 0)), slice(max(-d, 0), n - max(d, 0))


def _step(prev, cost, valid, p1: int, p2, label_ext):
    """L(p) = C(p) + min(L(p-r, l), N(p-r, l) + P1, m + P2) - m with m =
    min_k L(p-r, k); L(p) = C(p) where p - r lies outside (not valid).
    ``p2`` is an int or P2' of each line's pixel, shaped as ``m``."""
    m = prev.amin(dim=-1, keepdim=True)
    best = torch.minimum(
        torch.minimum(prev, _neighbour_min(prev, label_ext) + p1), m + p2)
    return torch.where(valid[..., None], cost + best - m, cost)


def path_cost(cost: torch.Tensor, direction, p1: int, p2,
              label_ext: int | None = None) -> torch.Tensor:
    """L_r over (..., H, W, nl) costs for one direction r = (dy, dx) of
    DIRS_16, as int32: a loop along the scan axis (x where dy = 0, else y),
    each step vectorised over frames, lines and labels.  A pixel whose
    p - r lies outside the frame starts its path (L = C): the first scan
    column where dy = 0, else the first |dy| scan rows and |dx| edge
    columns.  ``p2`` is an int, or an (..., H, W) integer tensor of P2'
    at each pixel p."""
    if tuple(direction) not in DIRS_16:
        raise ValueError(f"direction {direction} is none of {DIRS_16}")
    dy, dx = direction
    h, w = cost.shape[-3:-1]
    c = cost.to(torch.int32)
    out = torch.empty_like(c)
    if dy == 0:
        every = torch.ones(h, dtype=torch.bool, device=c.device)
        xs = range(w) if dx > 0 else range(w - 1, -1, -1)
        for i, x in enumerate(xs):
            out[..., x, :] = c[..., x, :] if i == 0 else _step(
                out[..., x - dx, :], c[..., x, :], every, p1,
                p2 if isinstance(p2, int) else p2[..., x, None], label_ext)
        return out
    valid = torch.zeros(w, dtype=torch.bool, device=c.device)
    cols, source = inside(w, dx)
    valid[cols] = True
    ys = range(h) if dy > 0 else range(h - 1, -1, -1)
    for i, y in enumerate(ys):
        if i < abs(dy):
            out[..., y, :, :] = c[..., y, :, :]
            continue
        prev = torch.full_like(c[..., y, :, :], INF)
        prev[..., cols, :] = out[..., y - dy, source, :]
        out[..., y, :, :] = _step(
            prev, c[..., y, :, :], valid, p1,
            p2 if isinstance(p2, int) else p2[..., y, :, None], label_ext)
    return out


def aggregate(cost: torch.Tensor, p1: int, p2,
              label_ext: int | None = None, dirs=DIRS_8) -> torch.Tensor:
    """S = sum over the directions of L_r, int32.  ``p2`` is an int, or a
    function of the direction r that gives r's (..., H, W) P2' table: one
    table and one L_r are held at a time."""
    s = None
    for r in dirs:
        l_r = path_cost(cost, r, p1, p2(r) if callable(p2) else p2,
                        label_ext)
        s = l_r if s is None else s.add_(l_r)
    return s


def wta(s: torch.Tensor) -> torch.Tensor:
    """argmin over the last axis, the smallest label on ties, int32."""
    lab = torch.arange(s.shape[-1], dtype=torch.int32, device=s.device)
    return ((s.to(torch.int32) << 8) | lab).amin(dim=-1) & 255


def parabola_offset(v_m, v_0, v_p, ok, control: str | None):
    """The vertex offset of the parabola through (-1, v_m), (0, v_0),
    (1, v_p) in float32 (or the control's bfloat16), 0 where not ok or
    the curvature is not positive, clamped to [-0.5, 0.5]; float32."""
    dt = torch.bfloat16 if control == "subpixel_bf16" else torch.float32
    v_m, v_0, v_p = (v.to(dt) for v in (v_m, v_0, v_p))
    denom = v_m - 2.0 * v_0 + v_p
    ok = ok & (denom > 0)
    off = torch.where(ok, (v_m - v_p) / torch.clamp(2.0 * denom, min=1e-12),
                      0.0).clamp(-0.5, 0.5)
    return off.to(torch.float32), ok


def median3x3(field: torch.Tensor) -> torch.Tensor:
    """3x3 median of (..., H, W), the edge repeated outward."""
    h, w = field.shape[-2:]
    rows = torch.arange(-1, h + 1, device=field.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=field.device).clamp(0, w - 1)
    padded = field.index_select(-2, rows).index_select(-1, cols)
    stack = torch.stack([padded[..., dy:dy + h, dx:dx + w]
                         for dy in range(3) for dx in range(3)])
    return stack.sort(dim=0).values[4]
