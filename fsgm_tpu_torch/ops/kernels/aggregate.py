"""K2: SGM path aggregation, one direction or one direction group a launch.

Replaces fsgm_tpu/ops/pallas/aggregate_tr.py::tr_family_sweep (and its
entries aggregate_paths_tr and, for B frames, aggregate_paths_tr_batch) on
the label-minor (H, W, D) volume of one frame or (B, H, W, D) of B frames:

    L_r(p, l) = C(p, l) + min(L(p-r, l), N(p-r, l) + P1,
                              m + P2'(p)) - m,     m = min_k L(p-r, k)

with L_r = C where p - r lies outside the image, and S = sum_r L_r.  The
neighbour term N is min(L[l-1], L[l+1]) for stereo's 1D labels
(make_tr_nmin_1d) and, with ``label_ext = e``, the 4-neighbour min over
flow's (e x e) label grid (make_tr_nmin_2d; golden/flow.py::
make_neighbor_min_2d).  ``nl`` is the number of real labels: a volume whose
D slots are padded past nl (the kernel takes D a multiple of 32) keeps the
pad slots out of every neighbour min and every m, and its S is 0 there.
The TPU's direction families, transposed horizontal volume, lane folds,
pads and knight parity slots were Mosaic layout devices and have no
counterpart: the CUDA kernel (csrc/sgm_sweep.cu) walks each path line of
one direction with one warp, for all B frames in one launch, its steps
arriving through a ring of cp.async copies in shared memory, its labels
carried as packed 16-bit pairs where ``packed16`` holds (int16 S, D/32
even and a stated bound ``p2_max`` on the P2' table; ``p2_bound`` gives it
for p2_effective's tables) and as int32 otherwise.  ``ring_plan`` mirrors
the kernel's shared memory.  Every function here takes (H, W, ...) as
B = 1.

Carry (tiled execution, fsgm_tpu_torch/parallel): a vertical direction
(dy != 0) can start from and export the scan state of fsgm_tpu/ops/
aggregate.py::aggregate_one_path, one (B, 2, W, D) int32 tensor per
direction in the canonical scan frame (row 0 the most recent row): carry-out
row 0 is L at the last row of the scan (y = H-1 for dy > 0, y = 0 for
dy < 0) and row 1 the row before it (carry-in row 0 when H = 1).  A line
that starts at scan row i < |dy| with its predecessor column x - dx inside
the image takes carry_in[|dy|-1-i, x-dx] as its previous L and runs the
normal recurrence; an all-zero carry gives L = C, the start of the image.
Label slots past nl are read as INF and written as 0.  This also replaces
the first-generation sweeps fsgm_tpu/ops/pallas/aggregate_pallas.py::
_row_sweep (vertical family with carries) and ::_col_sweep (horizontal)
that the tiled path of the JAX package runs.

Family launch (``sgm_sweep_family``): one launch sweeps several directions
of all B frames and adds the sum of their L_r into S, or writes it as a
fresh S.  It replaces fsgm_tpu/ops/pallas/aggregate_tr.py::
tr_dual_family_sweep (one launch for the directions with dy != 0, one for
those with dy = 0, as the JAX package's FSGM_TR_DUAL=1 path groups them)
and tools/trexp.py::tr_row_family_sweep (the dy = 1 family added into a
given S).  The kernel's S updates are atomic adds, exact for int16 S while
every S value stays in [0, 2^15), which plan_dtypes guarantees for the S it
plans.  It takes no carry: the tiled paths keep the per-direction launches.
``aggregate_paths`` plans its launches per direction group (``launch_plan``):
a group takes one family launch where its lines of all B frames are few
against the resident warps of the per-direction kernel, which the card
reports for the instantiation that would run (``resident_warps``,
``family_launch_pays``); there the per-direction launches leave the card
mostly idle and wait one after another.  Elsewhere the per-direction
launches win, because they need no atomics.  Both give the same S bit for
bit.

Also here, from fsgm_tpu/ops/pallas/aggregate_pallas.py: ``p2_effective``
(the P2' table, adaptive or not, with the two image rows beyond a tile's
seam) and ``plan_dtypes`` (int16 S where the preset's bound allows it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from fsgm_tpu_torch.ops.kernels import _build

INF = 1 << 30  # out-of-range label neighbour; INF + P2 + Cmax fits int32
MAX_FAMILY = 16  # directions of one family launch
# K2's packed labels (csrc/sgm_sweep.cu): unsigned 16-bit halves, SENTINEL
# marking an absent label.  Every L = C + (best - m) is at most 255 + P2'
# and every intermediate at most m + P2' <= 255 + 2 P2' or SENTINEL + P1,
# so P2' <= PACKED_P2_MAX and P1 <= PACKED_P1_MAX keep each half exact.
SENTINEL = 0x8000
PACKED_P2_MAX = (SENTINEL - 255) // 2
PACKED_P1_MAX = 0xFFFF - SENTINEL
# the ring of csrc/sgm_walk.cuh: four warps a block, at most RING_MAX steps
# of at most RING_BUDGET bytes a warp
WARPS_PER_BLOCK = 4
RING_MAX = 16
RING_BUDGET = 11264
MODES = ("fresh", "accum", "atomic")  # how a launch writes S
FAMILY_SHARE = 0.42  # family_launch_pays, fitted on the chip (PERF.md)


def plan_dtypes(s_max: int | None) -> torch.dtype:
    """S storage dtype: int16 when the largest S (s_max) fits, else int32."""
    return torch.int16 if s_max is not None and s_max < (1 << 15) \
        else torch.int32


def p2_bound(p1: int, p2: int) -> int | None:
    """A bound on every value p2_effective gives for p1, p2 (adaptive or
    not), or None where a table may hold a negative value."""
    return max(p2, p1 + 1) if min(p1, p2) >= 0 else None


def packed16(s_dtype: torch.dtype, nd: int, p1: int,
             p2_max: int | None) -> bool:
    """Whether K2 carries the labels as packed 16-bit pairs: int16 S, an
    even number K = D/32 of labels a lane, 0 <= P1 <= PACKED_P1_MAX and
    every P2' in [0, p2_max] with p2_max <= PACKED_P2_MAX, i.e. 255 + 2 P2'
    <= SENTINEL and SENTINEL + P1 <= 0xFFFF (csrc/sgm_sweep.cu).  Otherwise
    K2 computes in int32; both give the same S bit for bit."""
    return (s_dtype == torch.int16 and nd % 64 == 0
            and 0 <= p1 <= PACKED_P1_MAX and p2_max is not None
            and 0 <= p2_max <= PACKED_P2_MAX)


def ring_plan(nd: int, s_dtype: torch.dtype, mode: str,
              label_2d: bool = False, packed: bool = False) -> dict:
    """The shared memory of one K2 block (csrc/sgm_walk.cuh): ``steps`` of
    the ring (the largest power of two from 4 up to RING_MAX whose slots
    with an S row fit RING_BUDGET a warp), ``slot_bytes`` (the cost row,
    and the S row for "accum") and ``block_bytes`` (the four warps' rings,
    their two blocks of 32 P2' values and, for the 2D rule, their rows of
    the previous L)."""
    k, sb = nd // 32, torch.tensor([], dtype=s_dtype).element_size()
    steps = RING_MAX
    while steps > 4 and steps * 32 * k * (1 + sb) > RING_BUDGET:
        steps //= 2
    slot = 32 * k * (1 + (sb if mode == "accum" else 0))
    row = nd * (2 if packed else 4) if label_2d else 0
    return dict(steps=steps, slot_bytes=slot,
                block_bytes=WARPS_PER_BLOCK * (steps * slot + row + 64 * 4))


def p2_effective(img: torch.Tensor, direction: Tuple[int, int], p1: int,
                 p2: int, adaptive: bool, above2: torch.Tensor | None = None,
                 below2: torch.Tensor | None = None) -> torch.Tensor:
    """(..., H, W) int32 P2' for direction r: max(P1+1, P2 // max(1, |I(p) -
    I(p - r)|)) when adaptive, else P2.  above2 / below2 (..., 2, W) are the
    image rows [-2, -1] and [H, H+1] beyond a tile's seams (image order):
    the predecessors of the first |dy| scan rows of a down (dy > 0) or up
    (dy < 0) direction that continues from a carry.  Without them, and
    wherever p - r is outside the image (L = C there, P2' never read), the
    edge is clamped, at each frame's own edge."""
    h, w = img.shape[-2:]
    if not adaptive:
        return torch.full(img.shape, p2, dtype=torch.int32,
                          device=img.device)
    dy, dx = direction
    cur = img.to(torch.int32)
    rows = torch.arange(h, device=img.device)
    if dy > 0 and above2 is not None:
        src = torch.cat([above2.to(torch.int32), cur], dim=-2)
        ys = rows + 2 - dy
    elif dy < 0 and below2 is not None:
        src = torch.cat([cur, below2.to(torch.int32)], dim=-2)
        ys = rows - dy
    else:
        src, ys = cur, (rows - dy).clamp_(0, h - 1)
    xs = (torch.arange(w, device=img.device) - dx).clamp_(0, w - 1)
    pred = src.index_select(-2, ys).index_select(-1, xs)
    diff = (cur - pred).abs().clamp_(min=1)
    return (p2 // diff).clamp_(min=p1 + 1).to(torch.int32)


def _neighbor_min(prev: torch.Tensor, label_ext: int | None
                  ) -> torch.Tensor:
    """N over (..., nl) int32: min of the label neighbours, INF where none."""
    if label_ext is None:
        inf = torch.full_like(prev[..., :1], INF)
        return torch.minimum(torch.cat([inf, prev[..., :-1]], dim=-1),
                             torch.cat([prev[..., 1:], inf], dim=-1))
    e = label_ext
    g = prev.reshape(prev.shape[:-1] + (e, e))      # [..., dv, du]
    inf_row = torch.full_like(g[..., :1, :], INF)
    inf_col = torch.full_like(g[..., :, :1], INF)
    up = torch.cat([inf_row, g[..., :-1, :]], dim=-2)
    down = torch.cat([g[..., 1:, :], inf_row], dim=-2)
    left = torch.cat([inf_col, g[..., :, :-1]], dim=-1)
    right = torch.cat([g[..., :, 1:], inf_col], dim=-1)
    m = torch.minimum(torch.minimum(up, down), torch.minimum(left, right))
    return m.reshape(prev.shape)


def _recurrence(prev: torch.Tensor, cost: torch.Tensor, valid: torch.Tensor,
                p1: int, p2e: torch.Tensor, label_ext: int | None
                ) -> torch.Tensor:
    """One DP step over (..., nl) int32; golden/sgm.py::_recurrence."""
    m = prev.amin(dim=-1, keepdim=True)
    best = torch.minimum(
        torch.minimum(prev, _neighbor_min(prev, label_ext) + p1),
        m + p2e[..., None])
    return torch.where(valid[..., None], cost + best - m, cost)


def _labels(nd: int, label_ext: int | None, nl: int | None) -> int:
    """The real label count, checked against the volume's D slots."""
    nl = nd if nl is None else nl
    if not 0 < nl <= nd:
        raise ValueError(f"nl = {nl} must lie in [1, D = {nd}]")
    if label_ext is not None and (label_ext < 1
                                  or label_ext * label_ext != nl):
        raise ValueError(f"label_ext {label_ext} needs nl = label_ext^2, "
                         f"got {nl}")
    return nl


def _check_direction(direction: Tuple[int, int]) -> None:
    dy, dx = direction
    if (dy, dx) == (0, 0) or abs(dy) > 2 or abs(dx) > 2:
        raise ValueError(f"unsupported direction {direction}")


def _check_carry(cost: torch.Tensor, direction: Tuple[int, int],
                 init_carry: torch.Tensor | None, return_carry: bool) -> None:
    if direction[0] == 0 and (init_carry is not None or return_carry):
        raise ValueError(f"a carry needs a vertical direction, got "
                         f"{direction}")
    if init_carry is None:
        return
    want = tuple(cost.shape[:-3]) + (2,) + tuple(cost.shape[-2:])
    if init_carry.dtype != torch.int32 or tuple(init_carry.shape) != want:
        raise TypeError(f"carry must be {want} int32, got "
                        f"{tuple(init_carry.shape)} {init_carry.dtype}")
    if init_carry.device != cost.device:
        raise ValueError("carry and cost lie on different devices")


def _check_aligned(cost: torch.Tensor, s: torch.Tensor, name: str) -> None:
    """The kernel copies cost and S rows in 16-byte pieces."""
    if cost.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError(f"{name} needs cost and S aligned to 16 bytes")


def sgm_sweep_plain(cost: torch.Tensor, p2e: torch.Tensor,
                    direction: Tuple[int, int], p1: int,
                    label_ext: int | None = None,
                    nl: int | None = None,
                    init_carry: torch.Tensor | None = None,
                    return_carry: bool = False):
    """Plain PyTorch version: L_r as (..., H, W, D) int32, 0 in the slots
    past nl, and with return_carry also the carry out (module docstring).
    A Python loop over the scan axis, vectorised over frames x lines x
    labels."""
    dy, dx = direction
    h, w, nd = cost.shape[-3:]
    nl = _labels(nd, label_ext, nl)
    _check_carry(cost, direction, init_carry, return_carry)
    c = cost[..., :nl].to(torch.int32)
    out = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
    if dy == 0:
        every = torch.ones(h, dtype=torch.bool, device=cost.device)
        xs = range(w) if dx > 0 else range(w - 1, -1, -1)
        for i, x in enumerate(xs):
            if i < abs(dx):
                out[..., x, :nl] = c[..., x, :]
            else:
                out[..., x, :nl] = _recurrence(
                    out[..., x - dx, :nl], c[..., x, :], every, p1,
                    p2e[..., x], label_ext)
        return out
    ys = list(range(h) if dy > 0 else range(h - 1, -1, -1))
    for i, y in enumerate(ys):
        if i >= abs(dy):
            row = out[..., y - dy, :, :nl]
        elif init_carry is not None:
            row = init_carry[..., abs(dy) - 1 - i, :, :nl]
        else:
            out[..., y, :, :nl] = c[..., y, :, :]
            continue
        # the predecessor row shifted by dx, INF where x - dx is outside
        prev = torch.full_like(row, INF)
        valid = torch.zeros(w, dtype=torch.bool, device=cost.device)
        inside = slice(dx, None) if dx >= 0 else slice(None, dx)
        source = slice(None, w - dx) if dx >= 0 else slice(-dx, None)
        prev[..., inside, :] = row[..., source, :]
        valid[inside] = True
        out[..., y, :, :nl] = _recurrence(prev, c[..., y, :, :], valid, p1,
                                          p2e[..., y, :], label_ext)
    if not return_carry:
        return out
    carry = torch.zeros(cost.shape[:-3] + (2, w, nd), dtype=torch.int32,
                        device=cost.device)
    carry[..., 0, :, :] = out[..., ys[-1], :, :]
    if h > 1:
        carry[..., 1, :, :] = out[..., ys[-2], :, :]
    elif init_carry is not None:
        carry[..., 1, :, :nl] = init_carry[..., 0, :, :nl]
    return out, carry


def sgm_sweep_plain_into(cost: torch.Tensor, p2e: torch.Tensor,
                         direction: Tuple[int, int], p1: int,
                         s: torch.Tensor | None = None,
                         s_dtype: torch.dtype = torch.int16,
                         label_ext: int | None = None,
                         nl: int | None = None,
                         init_carry: torch.Tensor | None = None,
                         return_carry: bool = False,
                         p2_max: int | None = None):
    """sgm_sweep's contract (S += L_r, or a fresh S) through
    sgm_sweep_plain, on any device: what sgm_sweep does for CPU tensors,
    and what the tiled path's plain twin calls on the card (p2_max, a
    bound for the kernel's arithmetic, changes nothing here)."""
    got = sgm_sweep_plain(cost, p2e, direction, p1, label_ext, nl,
                          init_carry, return_carry)
    l_r, carry = got if return_carry else (got, None)
    l_r = l_r.to(s.dtype if s is not None else s_dtype)
    s = l_r if s is None else s.add_(l_r)
    return (s, carry) if return_carry else s


def sgm_sweep(cost: torch.Tensor, p2e: torch.Tensor,
              direction: Tuple[int, int], p1: int,
              s: torch.Tensor | None = None,
              s_dtype: torch.dtype = torch.int16,
              label_ext: int | None = None,
              nl: int | None = None,
              init_carry: torch.Tensor | None = None,
              return_carry: bool = False,
              p2_max: int | None = None):
    """Aggregate one direction: S += L_r in place and return S, or, with
    s None, return a fresh S = L_r in s_dtype; with return_carry, return
    (S, carry out).

    cost (H, W, D) or (B, H, W, D) u8 whose first nl (default D) slots are
    labels; p2e (H, W) or (B, H, W) int32 from p2_effective; |dy|, |dx| <=
    2; label_ext e: the labels form an (e x e) grid (flow), None: a line
    (stereo); init_carry (B, 2, W, D) (or (2, W, D)) int32 for dy != 0
    (module docstring); p2_max: a bound on p2e's values (p2_bound), with
    which the kernel may carry packed 16-bit labels (packed16), None if the
    caller knows none.  One kernel launch covers all B frames, each with
    its own carry slice."""
    dy, dx = direction
    _check_direction(direction)
    if cost.dtype != torch.uint8 or cost.dim() not in (3, 4):
        raise TypeError("sgm_sweep takes an (H, W, D) or (B, H, W, D) uint8 "
                        "cost volume")
    h, w, nd = cost.shape[-3:]
    nl = _labels(nd, label_ext, nl)
    _check_carry(cost, direction, init_carry, return_carry)
    if p2e.dtype != torch.int32 or p2e.shape != cost.shape[:-1]:
        raise TypeError(f"sgm_sweep takes a {tuple(cost.shape[:-1])} int32 "
                        f"P2' table, got {tuple(p2e.shape)} {p2e.dtype}")
    if s is not None:
        s_dtype = s.dtype
        if s.shape != cost.shape:
            raise ValueError(f"S shape {tuple(s.shape)} != "
                             f"{tuple(cost.shape)}")
    if s_dtype not in (torch.int16, torch.int32):
        raise TypeError(f"S dtype {s_dtype} is not int16 or int32")
    tensors = [cost, p2e] + ([s] if s is not None else [])
    if any(t.device != cost.device for t in tensors):
        raise ValueError("sgm_sweep inputs lie on different devices")
    if cost.device.type == "cpu":
        return sgm_sweep_plain_into(cost, p2e, direction, p1, s, s_dtype,
                                    label_ext, nl, init_carry, return_carry)
    if cost.device.type != "cuda":
        raise ValueError(f"sgm_sweep: unsupported device {cost.device}")
    if nd % 32 != 0 or nd > 256:
        raise ValueError(f"sgm_sweep kernel needs D a multiple of 32 up to "
                         f"256, got {nd}")
    if init_carry is not None:
        tensors.append(init_carry)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sgm_sweep takes contiguous tensors")
    fresh = s is None
    if fresh:
        s = torch.empty(cost.shape, dtype=s_dtype, device=cost.device)
    _check_aligned(cost, s, "sgm_sweep")
    carry = None
    if return_carry:
        # with H = 1 no walk reaches carry row 1: it is carry-in row 0
        alloc = torch.zeros if h < 2 else torch.empty
        carry = alloc(cost.shape[:-3] + (2, w, nd), dtype=torch.int32,
                      device=cost.device)
        if h == 1 and init_carry is not None:
            carry[..., 1, :, :nl] = init_carry[..., 0, :, :nl]
    if s.numel() > 0:
        b = cost.shape[0] if cost.dim() == 4 else 1
        fn = _build.load("sgm_sweep")
        with _build.on_device(cost):
            err = fn(cost.data_ptr(), p2e.data_ptr(), s.data_ptr(),
                     init_carry.data_ptr() if init_carry is not None else None,
                     carry.data_ptr() if carry is not None else None,
                     int(s_dtype == torch.int32), int(fresh),
                     int(packed16(s_dtype, nd, p1, p2_max)), b, h, w, nd,
                     nl, label_ext or 0, dy, dx, p1, _build.stream_of(cost))
        _build.check(err, "sgm_sweep")
        _build.LAUNCHES["sgm_sweep"] += 1
    return (s, carry) if return_carry else s


def sgm_sweep_family_plain(cost: torch.Tensor, p2e_tables,
                           directions: Sequence[Tuple[int, int]], p1: int,
                           label_ext: int | None = None,
                           nl: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the family launch: sum_r L_r over the
    directions as (..., H, W, D) int32, the per-direction plain sweeps
    summed; p2e_tables[j] is direction j's P2' table."""
    return sum(sgm_sweep_plain(cost, p2e, r, p1, label_ext, nl)
               for r, p2e in zip(directions, p2e_tables, strict=True))


def sgm_sweep_family(cost: torch.Tensor, p2e_tables: torch.Tensor,
                     directions: Sequence[Tuple[int, int]], p1: int,
                     s: torch.Tensor | None = None,
                     s_dtype: torch.dtype = torch.int16,
                     label_ext: int | None = None,
                     nl: int | None = None,
                     p2_max: int | None = None) -> torch.Tensor:
    """Aggregate several directions in one launch: S += sum_r L_r in place
    and return S, or, with s None, return a fresh S = sum_r L_r in
    s_dtype.  cost, label_ext and nl as for sgm_sweep; p2e_tables
    (n, B, H, W) int32 ((n, H, W) without a frame axis): table j is the
    P2' of direction j, as p2_effective gives it; at most 16 directions;
    p2_max as for sgm_sweep.
    An int16 S must hold values in [0, 2^15) before and after (the
    kernel's atomic adds; plan_dtypes guarantees it for its S).  The family
    launch takes no carry (module docstring): the tiled paths sweep one
    direction per launch (sgm_sweep)."""
    directions = [tuple(r) for r in directions]
    if not 0 < len(directions) <= MAX_FAMILY:
        raise ValueError(f"a family launch takes 1 to {MAX_FAMILY} "
                         f"directions, got {len(directions)}")
    for r in directions:
        _check_direction(r)
    if cost.dtype != torch.uint8 or cost.dim() not in (3, 4):
        raise TypeError("sgm_sweep_family takes an (H, W, D) or (B, H, W, "
                        "D) uint8 cost volume")
    h, w, nd = cost.shape[-3:]
    nl = _labels(nd, label_ext, nl)
    want = (len(directions),) + tuple(cost.shape[:-1])
    if p2e_tables.dtype != torch.int32 or tuple(p2e_tables.shape) != want:
        raise TypeError(f"sgm_sweep_family takes {want} int32 P2' tables, "
                        f"got {tuple(p2e_tables.shape)} {p2e_tables.dtype}")
    if s is not None:
        s_dtype = s.dtype
        if s.shape != cost.shape:
            raise ValueError(f"S shape {tuple(s.shape)} != "
                             f"{tuple(cost.shape)}")
    if s_dtype not in (torch.int16, torch.int32):
        raise TypeError(f"S dtype {s_dtype} is not int16 or int32")
    tensors = [cost, p2e_tables] + ([s] if s is not None else [])
    if any(t.device != cost.device for t in tensors):
        raise ValueError("sgm_sweep_family inputs lie on different devices")
    if cost.device.type == "cpu":
        total = sgm_sweep_family_plain(cost, p2e_tables, directions, p1,
                                       label_ext, nl).to(s_dtype)
        return total if s is None else s.add_(total)
    if cost.device.type != "cuda":
        raise ValueError(f"sgm_sweep_family: unsupported device "
                         f"{cost.device}")
    if nd % 32 != 0 or nd > 256:
        raise ValueError(f"sgm_sweep_family kernel needs D a multiple of 32 "
                         f"up to 256, got {nd}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sgm_sweep_family takes contiguous tensors")
    fresh = s is None
    if fresh:
        s = torch.empty(cost.shape, dtype=s_dtype, device=cost.device)
    _check_aligned(cost, s, "sgm_sweep_family")
    if s.numel() > 0:
        b = cost.shape[0] if cost.dim() == 4 else 1
        flat = [v for r in directions for v in r]
        dirs = (ctypes.c_int * len(flat))(*flat)
        fn = _build.load("sgm_sweep_family")
        with _build.on_device(cost):
            err = fn(cost.data_ptr(), p2e_tables.data_ptr(), s.data_ptr(),
                     int(s_dtype == torch.int32), int(fresh),
                     int(packed16(s_dtype, nd, p1, p2_max)), b, h, w, nd,
                     nl, label_ext or 0, len(directions), dirs, p1,
                     _build.stream_of(cost))
        _build.check(err, "sgm_sweep_family")
        _build.LAUNCHES["sgm_sweep_family"] += 1
    return s


def direction_groups(dirs: Sequence[Tuple[int, int]]) -> list:
    """The family launches of aggregate_paths: the directions with dy != 0,
    then those with dy = 0, each group in the order of dirs; an empty group
    is left out."""
    groups = [[r for r in dirs if r[0] != 0], [r for r in dirs if r[0] == 0]]
    return [g for g in groups if g]


def lines_per_frame(h: int, w: int, direction: Tuple[int, int]) -> int:
    """The path lines of one direction in an H x W frame, one warp each in
    K2 (csrc/sgm_sweep.cu::lines_of): a line starts at every pixel whose
    predecessor lies outside the image."""
    dy, dx = (abs(v) for v in direction)
    band = min(dy, h)
    return band * w + (h - band) * min(dx, w)


def resident_warps(device: torch.device, nd: int, s_dtype: torch.dtype,
                   label_2d: bool = False, packed: bool = False,
                   mode: str = "accum") -> int:
    """The warps of K2's instantiation for (D, S type, label rule, packed,
    mode) that the card of device holds at once: its occupancy on one SM
    (fsgm_sgm_sweep_occupancy, which asks the CUDA runtime about the built
    kernel) times the SMs; 0 off the card, where no kernel runs."""
    if device.type != "cuda":
        return 0
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _resident_warps(index, nd, s_dtype == torch.int32, label_2d,
                           packed, MODES.index(mode))


@functools.cache
def _resident_warps(index: int, nd: int, s_int32: bool, label_2d: bool,
                    packed: bool, mode: int) -> int:
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.load("sgm_sweep_occupancy")(
            int(s_int32), mode, int(label_2d), int(packed), nd,
            ctypes.byref(per_sm))
    _build.check(err, "sgm_sweep_occupancy")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * per_sm.value


def family_launch_pays(frames: int, h: int, w: int,
                       group: Sequence[Tuple[int, int]], nd: int,
                       warps: int) -> bool:
    """Whether one family launch of a direction group beats one launch per
    direction: while frames x the most lines of one direction
    (lines_per_frame) x K^1.5 stays below FAMILY_SHARE x the group's
    directions x ``warps``, the resident warps of the per-direction kernel
    (resident_warps), K = D / 32 the labels a lane holds.  A per-direction
    launch whose lines (one warp each) leave most of the card idle waits on
    its serial chain, and the group's launches wait one after another; the
    family launch walks them side by side but adds into S by atomics, K / 2
    words a step and direction, which cost more against the per-direction
    read-modify-write the more labels a lane holds.  FAMILY_SHARE and the
    power of K are fitted on the chip at D = 64 and D = 128 (PERF.md)."""
    k = nd // 32
    most = max(lines_per_frame(h, w, r) for r in group)
    return frames * most * k * k ** 0.5 < FAMILY_SHARE * len(group) * warps


def launch_plan(shape: Sequence[int], device: torch.device,
                dirs: Sequence[Tuple[int, int]], p1: int, p2: int,
                s_max: int | None = None,
                label_ext: int | None = None) -> list:
    """aggregate_paths' K2 launches for a cost volume of ``shape`` ((H, W,
    D) or (B, H, W, D)) on ``device``: [(direction group, True for one
    family launch or False for one launch per direction)] over
    direction_groups(dirs), each group by family_launch_pays over the
    resident warps of the per-direction kernel that would run
    (resident_warps)."""
    h, w, nd = shape[-3:]
    frames = shape[0] if len(shape) == 4 else 1
    s_dtype = plan_dtypes(s_max)
    warps = resident_warps(device, nd, s_dtype, label_ext is not None,
                           packed16(s_dtype, nd, p1, p2_bound(p1, p2)))
    return [(group, family_launch_pays(frames, h, w, group, nd, warps))
            for group in direction_groups(dirs)]


def aggregate_paths(cost: torch.Tensor, img: torch.Tensor,
                    dirs: Sequence[Tuple[int, int]], p1: int, p2: int,
                    adaptive_p2: bool = False,
                    s_max: int | None = None,
                    label_ext: int | None = None,
                    nl: int | None = None) -> torch.Tensor:
    """S = sum_r L_r for all frames; cost's shape ((H, W, D) or
    (B, H, W, D), img (H, W) or (B, H, W)) in plan_dtypes(s_max).  For
    each direction group (direction_groups: dy != 0, then dy = 0) one
    sgm_sweep_family launch where launch_plan gives it the family launch on
    cost's card, else one sgm_sweep launch per direction; the P2' bound
    p2_bound(p1, p2) lets the kernel carry packed labels.  Every plan gives
    the same S bit for bit."""
    kw = dict(s_dtype=plan_dtypes(s_max), label_ext=label_ext, nl=nl,
              p2_max=p2_bound(p1, p2))
    s = None
    for group, family in launch_plan(cost.shape, cost.device, dirs, p1, p2,
                                     s_max, label_ext):
        if family:
            tables = torch.stack([p2_effective(img, r, p1, p2, adaptive_p2)
                                  for r in group])
            s = sgm_sweep_family(cost, tables, group, p1, s=s, **kw)
            continue
        for r in group:  # one P2' table at a time
            s = sgm_sweep(cost, p2_effective(img, r, p1, p2, adaptive_p2), r,
                          p1, s=s, **kw)
    return s


def aggregate_paths_plain(cost: torch.Tensor, img: torch.Tensor,
                          dirs: Sequence[Tuple[int, int]], p1: int, p2: int,
                          adaptive_p2: bool = False,
                          s_max: int | None = None,
                          label_ext: int | None = None,
                          nl: int | None = None) -> torch.Tensor:
    """aggregate_paths through the plain sweeps on any device."""
    s = sum(sgm_sweep_plain(cost, p2_effective(img, r, p1, p2, adaptive_p2),
                            r, p1, label_ext, nl) for r in dirs)
    return s.to(plan_dtypes(s_max))
