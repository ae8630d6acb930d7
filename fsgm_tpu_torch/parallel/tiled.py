"""Tiled stereo SGM over a grid of devices: frame shards x row tiles x
column tiles, in one process or with the frame shards over ranks.

Counterpart of fsgm_tpu/parallel/tiled.py (``stereo_sgm_sharded``).  The
JAX package runs one SPMD program per device of a ("frame", "ty", "tx")
mesh and exchanges with ppermute / all_gather.  Here one process holds the
tiles in lists, each tile on its own ``torch.device``, and an exchange is
``tensor.to(device)``, so the same schedule runs on the CPU, on one card
and on several cards of one host (a caller lists them in ``devices``).
Given a RankMesh (parallel/multihost.py) instead, each torch.distributed
rank runs its own frame shards so and the ranks gather the frames.

  * frame shards: F / frame_shards frames per shard, which go through K1,
    K2 and K3 as one batch (B);
  * row tiles: census reads ``halo`` true rows of each neighbour; the cost,
    the horizontal paths and the extraction are row-local; the vertical
    path families cross the seams as K2's carry (ops/kernels/aggregate.py),
    one (B, 2, W, D) int32 tensor per direction.  Two modes:
      "exact"  the bit-true wavefront: step k runs the down family on tile
               k and the up family on tile t-1-k, and hands both carries on;
      "fast"   two-pass margin re-injection: pass 1 sweeps every tile from
               the start-of-image state into a fresh per-family S, pass 2
               re-sweeps the first (down) or last (up) ``margin`` rows from
               the carry the neighbour's pass 1 exported and replaces those
               rows; exact up to SGM's forgetting length
               (params.forgetting_margin, the default margin);
  * column tiles: each tile computes on a window of margin + D + census
    radius extra columns per side, gathered from its row band, and crops;
    the cost, the right-view WTA, the LR check and the median's edge are
    taken in global columns, and window columns outside the image carry
    the neutral cost 0 (a path through them reaches the image as L = C).

There is no backend switch: CUDA tensors launch the kernels, CPU tensors
take their plain versions, and ``stereo_sgm_sharded_reference`` composes
only the plain versions on any device.  ``counters``, when given, is a
dict that receives "rows" (family -> the rows swept by each active call of
a vertical family) and "bytes" (kind -> the bytes of every tensor handed
from one tile to another: "carry", "halo", "gather"), counted whether or
not the two tiles share a device.  A fault of the reference is refused
instead of copied: it never applies ``fill_invalid`` to a tiled run; the
port raises.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from fsgm_tpu_torch.params import (INVALID, DistParams, SGMParams,
                                   forgetting_margin)
from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.kernels import aggregate as agg
from fsgm_tpu_torch.ops.kernels import cost as kcost
from fsgm_tpu_torch.ops.kernels import extract as kext
from fsgm_tpu_torch.parallel.multihost import RankMesh, run_rank_shards


# --------------------------------------------------------------------------
# Devices, counters and exchanges between tiles
# --------------------------------------------------------------------------

def device_grid(devices, shape: Tuple[int, ...], default: torch.device):
    """The device of each tile, nested in ``shape``'s order: ``devices`` is
    a list of len(prod(shape)) devices in that order (nested lists are
    flattened), or None for every tile on ``default``."""
    n = 1
    for k in shape:
        n *= k
    if devices is None:
        flat = [default] * n
    else:
        flat = [torch.device(d) for d in _flatten(devices)]
    if len(flat) != n:
        raise ValueError(f"devices lists {len(flat)} devices for a "
                         f"{' x '.join(map(str, shape))} tile grid")
    for k in reversed(shape[1:]):
        flat = [flat[i:i + k] for i in range(0, len(flat), k)]
    return flat


def _flatten(x):
    if isinstance(x, (list, tuple)):
        return [d for y in x for d in _flatten(y)]
    return [x]


def count_bytes(counters: dict | None, kind: str, x: torch.Tensor) -> None:
    if counters is not None:
        got = counters.setdefault("bytes", {})
        got[kind] = got.get(kind, 0) + x.numel() * x.element_size()


def count_rows(counters: dict | None, family: str, rows: int) -> None:
    if counters is not None:
        counters.setdefault("rows", {}).setdefault(family, []).append(rows)


def hand(x: torch.Tensor, device: torch.device, counters: dict | None,
         kind: str) -> torch.Tensor:
    """x handed from one tile to the tile on ``device`` (counted)."""
    count_bytes(counters, kind, x)
    return x.to(device)


def exchange_row_halo(tiles: Sequence[torch.Tensor], halo: int,
                      counters: dict | None, dim: int = -2
                      ) -> list[torch.Tensor]:
    """Each row tile extended along ``dim`` by ``halo`` true rows of its
    neighbours on each side; the global top and bottom repeat the edge row
    (the census' and the median's edge padding)."""
    t = len(tiles)
    out = []
    for k, x in enumerate(tiles):
        ht = x.shape[dim]
        if t > 1 and ht < halo:
            raise ValueError(f"row tiles of {ht} rows are shorter than the "
                             f"{halo}-row halo")
        if k > 0:
            prev = tiles[k - 1]
            above = hand(prev.narrow(dim, prev.shape[dim] - halo, halo),
                         x.device, counters, "halo")
        else:
            above = x.narrow(dim, 0, 1).repeat_interleave(halo, dim)
        if k < t - 1:
            below = hand(tiles[k + 1].narrow(dim, 0, halo), x.device,
                         counters, "halo")
        else:
            below = x.narrow(dim, ht - 1, 1).repeat_interleave(halo, dim)
        out.append(torch.cat([above, x, below], dim))
    return out


def gather_rows(tiles: Sequence[torch.Tensor], counters: dict | None,
                dim: int = -2) -> list[torch.Tensor]:
    """The whole array for every row tile, the tiles joined along their
    row axis ``dim`` (-2 for (..., Ht, W) images, -3 for (..., Ht, W, 2)
    flow), on the tile's device (all_gather); the pieces of the other tiles
    are counted as handed, however many tiles share a device, and a device
    builds its copy once."""
    full = {}
    out = []
    for k, x in enumerate(tiles):
        for j, y in enumerate(tiles):
            if j != k:
                count_bytes(counters, "gather", y)
        if x.device not in full:
            full[x.device] = torch.cat([y.to(x.device) for y in tiles], dim)
        out.append(full[x.device])
    return out


def tile_margin(params, dist: DistParams) -> int:
    """dist.margin, or SGM's forgetting length for params (SGMParams or
    FlowParams) when it is 0: the rows fast mode re-sweeps across a seam,
    and the path columns a column window adds on each side."""
    return dist.margin or forgetting_margin(params.p1, params.p2,
                                            cmax=params.invalid_cost)


def window_extension(params: SGMParams, dist: DistParams) -> int:
    """The columns a column tile's window adds on each side: the path
    margin, the disparity range and the census radius."""
    return (tile_margin(params, dist) + params.max_disp
            + params.census_window[1] // 2)


def per_device(fn: Callable, xs: Sequence[torch.Tensor]) -> list:
    """fn(x) once per device, for a list of tensors equal on each device."""
    memo = {}
    out = []
    for x in xs:
        if x.device not in memo:
            memo[x.device] = fn(x)
        out.append(memo[x.device])
    return out


# --------------------------------------------------------------------------
# Tiled aggregation
# --------------------------------------------------------------------------

def split_dirs(dirs: Sequence[Tuple[int, int]]):
    horiz = [r for r in dirs if r[0] == 0]
    down = [r for r in dirs if r[0] > 0]
    up = [r for r in dirs if r[0] < 0]
    if len(down) != len(up):
        raise ValueError(f"direction set {dirs} must be y-symmetric")
    return horiz, down, up


def aggregate_tiled(costs: Sequence[torch.Tensor],
                    guides: Sequence[torch.Tensor], halos, dirs,
                    p1: int, p2: int, adaptive: bool, tile_mode: str,
                    margin: int, counters: dict | None,
                    s_dtype: torch.dtype, label_ext: int | None = None,
                    nl: int | None = None, plain: bool = False
                    ) -> list[torch.Tensor]:
    """S of each row tile of one chain: costs (..., Ht, W, D) u8 and guide
    images (..., Ht, W), tile k on its own device; halos[k] = (above2,
    below2), the two image rows beyond each seam.  K2 per direction (its
    plain version with ``plain``), with carries across the seams for the
    vertical directions: the counterpart of the JAX package's
    _aggregate_tiled_exact / _aggregate_tiled_fast, whose three family
    backends collapse into K2."""
    t = len(costs)
    ht = costs[0].shape[-3]
    sweep = agg.sgm_sweep_plain_into if plain else agg.sgm_sweep
    horiz, down, up = split_dirs(dirs)
    kw = dict(s_dtype=s_dtype, label_ext=label_ext, nl=nl,
              p2_max=agg.p2_bound(p1, p2))

    def p2e(k, fam):
        """Tile k's P2' table of each direction in fam."""
        return [agg.p2_effective(guides[k], r, p1, p2, adaptive, *halos[k])
                for r in fam]

    def family(k, fam, tabs, carries, s=None, rows=slice(None)):
        """Sweep ``fam`` over tile k's ``rows`` into s; the carries out."""
        c = costs[k][..., rows, :, :].contiguous()
        outs = []
        for r, tab, cin in zip(fam, tabs, carries):
            s, cout = sweep(c, tab[..., rows, :].contiguous(), r, p1, s=s,
                            init_carry=cin, return_carry=True, **kw)
            outs.append(cout)
        return s, outs

    s = [None] * t
    for k in range(t):
        for r in horiz + ([] if t > 1 else down + up):
            s[k] = sweep(costs[k], p2e(k, [r])[0], r, p1, s=s[k], **kw)
    if t == 1:
        return s
    start = [None] * len(down)          # the start-of-image state
    if tile_mode == "exact":
        carry_d, carry_u = start, start
        for k in range(t):
            ku = t - 1 - k
            count_rows(counters, "down", ht)
            s[k], carry_d = family(k, down, p2e(k, down), carry_d, s[k])
            count_rows(counters, "up", ht)
            s[ku], carry_u = family(ku, up, p2e(ku, up), carry_u, s[ku])
            if k < t - 1:
                carry_d = [hand(c, costs[k + 1].device, counters, "carry")
                           for c in carry_d]
                carry_u = [hand(c, costs[ku - 1].device, counters, "carry")
                           for c in carry_u]
        return s
    m = min(margin, ht)
    for fam, step, tag in ((down, 1, "down"), (up, -1, "up")):
        tabs = [p2e(k, fam) for k in range(t)]
        fresh, couts = [], []
        for k in range(t):
            count_rows(counters, tag, ht)
            s_fam, cout = family(k, fam, tabs[k], start)
            fresh.append(s_fam)
            couts.append(cout)
        rows = slice(0, m) if step > 0 else slice(ht - m, ht)
        for k in range(t):
            src = k - step
            count_rows(counters, tag, m)
            # the first tile of the scan (no source) would re-sweep its
            # rows from the start state: pass 1's own values, so skipped
            if 0 <= src < t:
                carry = [hand(c, costs[k].device, counters, "carry")
                         for c in couts[src]]
                fresh[k][..., rows, :, :] = family(k, fam, tabs[k], carry,
                                                   rows=rows)[0]
            s[k] = fresh[k] if s[k] is None else s[k].add_(fresh[k])
        del tabs
    return s


# --------------------------------------------------------------------------
# The stereo pipeline over one chain of row tiles
# --------------------------------------------------------------------------

def _globalize_cost(cost: torch.Tensor, gx0: int, w_global: int,
                    invalid_cost: int, right_reference: bool
                    ) -> torch.Tensor:
    """A window's cost in global columns: a match outside [0, w_global)
    costs invalid_cost, and a column outside the image costs 0, the
    neutral value (a path through it reaches the image as L = C)."""
    wc, nd = cost.shape[-2:]
    gx = torch.arange(wc, device=cost.device)[:, None] + gx0
    ds = torch.arange(nd, device=cost.device)[None, :]
    match_ok = gx + ds < w_global if right_reference else gx - ds >= 0
    in_img = (gx >= 0) & (gx < w_global)
    return cost.masked_fill(~match_ok, invalid_cost).masked_fill(~in_img, 0)


def _fill_window_edges(disp: torch.Tensor, gx0: int, w_global: int
                       ) -> torch.Tensor:
    """Window columns outside the image take the edge column's values, so
    the median replicates at the global image edge."""
    wc = disp.shape[-1]
    first, last = max(0, -gx0), min(wc, w_global - gx0) - 1
    cols = torch.arange(wc, device=disp.device).clamp_(first, last)
    return disp.index_select(-1, cols)


def _stereo_chain(tl: list, tr: list, params: SGMParams, dist: DistParams,
                  counters: dict | None, plain: bool, gx0: int = 0,
                  w_global: int | None = None) -> list[torch.Tensor]:
    """One chain of row tiles ((B, Ht, Wc) u8 pairs, tile k on its own
    device) -> its (B, Ht, Wc) float32 disparity tiles.  With w_global the
    tiles are windows whose column x is the global column gx0 + x."""
    ch = params.census_window[0]
    halo = max(ch // 2, 2)
    ht = tl[0].shape[-2]
    il_ext = exchange_row_halo(tl, halo, counters)
    ir_ext = exchange_row_halo(tr, halo, counters)
    cen_l = [census_transform(x, params.census_window, plain)
             [..., halo:-halo, :].contiguous() for x in il_ext]
    cen_r = [census_transform(x, params.census_window, plain)
             [..., halo:-halo, :].contiguous() for x in ir_ext]
    margin = tile_margin(params, dist)
    build = kcost.census_cost_plain if plain else kcost.census_cost
    extract = kext.extract_stereo_plain if plain else kext.extract_stereo
    windowed = w_global is not None

    def s_volumes(right_reference: bool) -> list[torch.Tensor]:
        costs = []
        for cl, cr in zip(cen_l, cen_r):
            c = build(cl, cr, params.max_disp, params.invalid_cost,
                      right_reference, params.census_bits)
            if windowed:
                c = _globalize_cost(c, gx0, w_global, params.invalid_cost,
                                    right_reference)
            costs.append(c)
        exts = ir_ext if right_reference else il_ext
        halos = [(x[..., halo - 2:halo, :], x[..., halo + ht:halo + ht + 2, :])
                 for x in exts]
        return aggregate_tiled(
            costs, tr if right_reference else tl, halos, params.dirs,
            params.p1, params.p2, params.adaptive_p2, dist.tile_mode, margin,
            counters, agg.plan_dtypes(params.s_invalid), plain=plain)

    d_right = None
    if params.lr_check and params.lr_mode == "reagg":
        # first, so that the right S volumes are freed before the left ones
        d_right = [extract(s, params.s_invalid, params.lr_max_diff,
                           with_sub=False, with_rwta=False)[0]
                   for s in s_volumes(True)]
    need_rwta = params.lr_check and d_right is None
    s_left = s_volumes(False)
    disps = []
    for k in range(len(tl)):
        d_int, s_m, s_0, s_p, valid = extract(
            s_left[k], params.s_invalid, params.lr_max_diff, params.subpixel,
            with_rwta=need_rwta, gx0=gx0, w_global=w_global)
        s_left[k] = None
        disp = d_int.to(torch.float32)
        if params.subpixel:
            disp = ext.subpixel_from_neighborhood(d_int, s_m, s_0, s_p,
                                                  params.max_disp)
        if need_rwta:
            disp = torch.where(valid != 0, disp, INVALID)
        elif params.lr_check:
            disp = ext.lr_check(disp, d_right[k], params.lr_max_diff,
                                params.max_disp, x_lo=max(0, -gx0))
        if params.median_filter and windowed:
            disp = _fill_window_edges(disp, gx0, w_global)
        disps.append(disp)
    if params.median_filter:
        disps = [ext.median_filter_3x3(x)[..., 1:-1, :]
                 for x in exchange_row_halo(disps, 1, counters)]
    return disps


def _window(row: list, x: int, ex: int, counters: dict | None
            ) -> torch.Tensor:
    """Column tile x's window of its row band (the row's tiles gathered
    along W): ex columns beyond each side, the image edge repeated."""
    dev = row[x].device
    band = torch.cat([y if j == x else hand(y, dev, counters, "gather")
                      for j, y in enumerate(row)], dim=-1)
    wt, w = row[x].shape[-1], band.shape[-1]
    cols = (torch.arange(wt + 2 * ex, device=dev) + x * wt - ex
            ).clamp_(0, w - 1)
    return band.index_select(-1, cols)


def _check(imgs_l: torch.Tensor, imgs_r: torch.Tensor, params: SGMParams,
           dist: DistParams) -> None:
    if imgs_l.shape != imgs_r.shape or imgs_l.dim() != 3:
        raise ValueError(f"image shapes {tuple(imgs_l.shape)} and "
                         f"{tuple(imgs_r.shape)} must be equal (F, H, W)")
    if imgs_l.device != imgs_r.device:
        raise ValueError("images lie on different devices")
    f, h, w = imgs_l.shape
    if f % dist.frame_shards or h % dist.tiles_y or w % dist.tiles_x:
        raise ValueError(f"(F, H, W) = {(f, h, w)} must divide by "
                         f"(frame_shards, tiles_y, tiles_x) = "
                         f"{(dist.frame_shards, dist.tiles_y, dist.tiles_x)}")
    if params.fill_invalid:
        raise ValueError("fill_invalid is not supported under tiling")


def _sharded(imgs_l: torch.Tensor, imgs_r: torch.Tensor, params: SGMParams,
             dist: DistParams, devices, counters: dict | None,
             plain: bool) -> torch.Tensor:
    _check(imgs_l, imgs_r, params, dist)
    if isinstance(devices, RankMesh):
        return run_rank_shards(
            devices, dist, lambda a, b, d, devs: _sharded(
                a, b, params, d, devs, counters, plain), imgs_l, imgs_r)
    f, h, w = imgs_l.shape
    fs, ty, tx = dist.frame_shards, dist.tiles_y, dist.tiles_x
    grid = device_grid(devices, (fs, ty, tx), imgs_l.device)
    fl, ht, wt = f // fs, h // ty, w // tx
    out = torch.empty((f, h, w), dtype=torch.float32, device=imgs_l.device)
    ex = window_extension(params, dist)
    for a in range(fs):
        frames = slice(a * fl, (a + 1) * fl)

        def tiles(img):
            return [[img[frames, y * ht:(y + 1) * ht, x * wt:(x + 1) * wt]
                     .to(grid[a][y][x]).contiguous() for x in range(tx)]
                    for y in range(ty)]

        tl, tr = tiles(imgs_l), tiles(imgs_r)
        for x in range(tx):
            if tx == 1:
                disps = _stereo_chain([row[0] for row in tl],
                                      [row[0] for row in tr], params, dist,
                                      counters, plain)
            else:
                disps = _stereo_chain(
                    [_window(row, x, ex, counters) for row in tl],
                    [_window(row, x, ex, counters) for row in tr], params,
                    dist, counters, plain, gx0=x * wt - ex, w_global=w)
                disps = [d[..., ex:ex + wt] for d in disps]
            for y, d in enumerate(disps):
                out[frames, y * ht:(y + 1) * ht, x * wt:(x + 1) * wt] = \
                    d.to(out.device)
    return out


def stereo_sgm_sharded(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                       params: SGMParams, dist: DistParams, devices=None,
                       counters: dict | None = None) -> torch.Tensor:
    """(F, H, W) uint8 pairs -> (F, H, W) float32 disparity, INVALID = -1.

    F is split into dist.frame_shards shards, rows into dist.tiles_y tiles
    and columns into dist.tiles_x tiles; each must divide evenly.
    With one column tile, dist.tile_mode "exact" is bit-identical to
    stereo_sgm_batch; "fast" is the margin re-injection (dist.margin rows,
    0 = forgetting_margin).
    Column tiling (tiles_x > 1) is, like fast mode, exact only up to SGM's
    forgetting length: a path into a window starts fresh at the window's
    edge, margin columns beyond the tile.
    ``devices``: a frame_shards x tiles_y x tiles_x list in (frame, ty, tx)
    order (default: every tile on the images' device), or this rank's
    RankMesh (parallel/multihost.py: frame_shards must equal its frame
    axis; the rank runs its own shards on its tiles_y x tiles_x local
    devices and gathers every rank's frames); ``counters``: see the module
    docstring (a rank's own tiles only).  The result lies on the images'
    device."""
    return _sharded(imgs_l, imgs_r, params, dist, devices, counters,
                    plain=False)


def stereo_sgm_sharded_reference(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                                 params: SGMParams, dist: DistParams,
                                 devices=None,
                                 counters: dict | None = None
                                 ) -> torch.Tensor:
    """stereo_sgm_sharded through the plain PyTorch versions only."""
    return _sharded(imgs_l, imgs_r, params, dist, devices, counters,
                    plain=True)
