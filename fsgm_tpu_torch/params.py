"""Parameter dataclasses of the PyTorch port: SGM stereo, fSGM flow and
distribution settings, and the configs/*.json preset loader.

The port's own copy of fsgm_tpu/params.py (stdlib only).  The field sets,
defaults, validation and JSON format are the JAX package's, field for
field, so every configs/*.json preset loads into equal parameter objects
in both packages (tests/test_torch_presets.py holds them equal).

SGM has no learned weights: the parameter set is the whole state a run
carries.  All classes are frozen and hashable.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

# 8-path direction set: (dy, dx) of the path step r; the predecessor of
# pixel p along path r is p - r.  (Hirschmueller, PAMI 2008, Sec. 2.3.)
DIRS_8: Tuple[Tuple[int, int], ...] = (
    (0, 1), (0, -1), (1, 0), (-1, 0),
    (1, 1), (1, -1), (-1, 1), (-1, -1),
)

# 16-path set adds the eight "knight-move" directions.
DIRS_16: Tuple[Tuple[int, int], ...] = DIRS_8 + (
    (1, 2), (1, -2), (-1, 2), (-1, -2),
    (2, 1), (2, -1), (-2, 1), (-2, -1),
)

# Sentinel for invalidated pixels in disparity fields (post LR-check).
INVALID = -1.0


@dataclasses.dataclass(frozen=True)
class SGMParams:
    """Stereo SGM configuration.

    Integer-exact pipeline: census -> Hamming cost (u8) -> path aggregation
    -> WTA.  Everything up to WTA is integer arithmetic.
    """

    max_disp: int = 64                 # D: disparities searched, d in [0, D)
    p1: int = 7                        # small smoothness penalty (|dd| == 1)
    p2: int = 100                      # large smoothness penalty (|dd| > 1)
    num_paths: int = 8                 # 8 or 16 aggregation paths
    census_window: Tuple[int, int] = (5, 5)   # (height, width), odd; <= 63 bits
    adaptive_p2: bool = False          # P2' = max(P1+1, P2 // max(1, |dI|))
    subpixel: bool = True              # quadratic (parabola) refinement
    lr_check: bool = True              # left-right consistency check
    lr_mode: str = "s_trick"           # 's_trick': d_R = argmin_d S(y,x+d,d)
                                       # 'reagg': true right-reference
                                       # re-aggregation (2x aggregation cost)
    lr_max_diff: int = 1               # |d_L - d_R| tolerance in pixels
    median_filter: bool = True         # 3x3 median post-filter
    fill_invalid: bool = False         # background-interpolate LR-failed px
    invalid_cost: int = 255            # cost for out-of-range matches (u8 max)

    def __post_init__(self):
        ch, cw = self.census_window
        bits = ch * cw - 1
        if bits > 63:
            raise ValueError(f"census window {self.census_window} needs {bits} bits > 63")
        if ch % 2 == 0 or cw % 2 == 0:
            raise ValueError("census window dims must be odd")
        if self.num_paths not in (4, 8, 16):
            raise ValueError("num_paths must be 4, 8 or 16")
        if self.lr_mode not in ("s_trick", "reagg"):
            raise ValueError("lr_mode must be 's_trick' or 'reagg'")
        # S = sum_r L_r with L_r <= Cmax + P2 must fit u16.
        cmax = min(bits, self.invalid_cost)
        if self.num_paths * (cmax + self.p2) >= 1 << 16:
            raise ValueError(
                f"S overflow risk: {self.num_paths}*({cmax}+{self.p2}) >= 2^16; "
                "lower P2 or use fewer paths")

    @property
    def dirs(self) -> Tuple[Tuple[int, int], ...]:
        if self.num_paths == 16:
            return DIRS_16
        return DIRS_8[: self.num_paths]

    @property
    def census_bits(self) -> int:
        ch, cw = self.census_window
        return ch * cw - 1

    @property
    def s_invalid(self) -> int:
        """Fill value strictly larger than any achievable S, used for
        out-of-range entries in the right-WTA S-volume trick."""
        return self.num_paths * (self.invalid_cost + self.p2) + 1


@dataclasses.dataclass(frozen=True)
class FlowParams:
    """fSGM optical-flow configuration (hierarchical 2D search).

    At each pyramid level the label space is the (2w+1)^2 grid of integer
    flow offsets centered on the 2x-upsampled coarser flow.
    """

    search_radius: int = 4             # w: labels = (2w+1)^2
    levels: int = 4                    # pyramid levels (level 0 = full res)
    p1: int = 7
    p2: int = 100
    census_window: Tuple[int, int] = (5, 5)
    adaptive_p2: bool = False
    subpixel: bool = True              # separable 2D parabola
    fb_check: bool = True              # forward-backward consistency (finest level)
    fb_max_diff: float = 1.0
    # Backward-pass variant for fb_check.  Intermediate backward levels
    # always keep subpixel + median: they feed the next level's prior.
    #   "full"   - backward pass identical to forward
    #   "cheap"  - the FINAL backward level skips subpixel and median
    #   "single" - one backward SGM level at finest resolution with the
    #              negated forward flow as prior (no backward pyramid);
    #              subpixel/median skipped
    #   "half"   - backward pyramid stops at level 1 (half resolution) and
    #              the result is 2x-upsampled for fb_check; full extraction
    #              at every backward level
    fb_backward: str = "full"
    # Grid the FB check itself runs on:
    #   "full" - per-pixel check at full resolution
    #   "half" - both fields box-downsampled 2x, checked on the half grid
    #            with tolerance fb_max_diff/2, validity plane 2x-upsampled
    fb_grid: str = "full"
    median_filter: bool = True
    invalid_cost: int = 255

    def __post_init__(self):
        ch, cw = self.census_window
        if ch * cw - 1 > 63:
            raise ValueError("census window too large")
        if self.fb_backward not in ("full", "cheap", "single", "half"):
            raise ValueError(f"unknown fb_backward: {self.fb_backward!r}")
        if self.fb_backward == "half" and self.levels < 2:
            raise ValueError("fb_backward='half' needs levels >= 2")
        if self.fb_grid not in ("full", "half"):
            raise ValueError(f"unknown fb_grid: {self.fb_grid!r}")
        cmax = min(ch * cw - 1, self.invalid_cost)
        if 8 * (cmax + self.p2) >= 1 << 16:
            raise ValueError("S overflow risk in flow aggregation")

    @property
    def num_labels(self) -> int:
        return (2 * self.search_radius + 1) ** 2

    @property
    def window_extent(self) -> int:
        return 2 * self.search_radius + 1

    @property
    def census_bits(self) -> int:
        ch, cw = self.census_window
        return ch * cw - 1


@dataclasses.dataclass(frozen=True)
class DistParams:
    """Distribution configuration.

    tiles_y/tiles_x shard the image spatially across devices; frame_shards
    shards independent frames across hosts.  tile_mode 'exact' = bit-true
    wavefront; 'fast' = two-pass margin re-injection.
    """

    tiles_y: int = 1
    tiles_x: int = 1
    frame_shards: int = 1
    tile_mode: str = "exact"           # 'exact' | 'fast'
    margin: int = 0                    # 'fast' re-injection margin in rows;
                                       # 0 = auto (forgetting_margin of the
                                       # SGM/Flow params at the call site)

    def __post_init__(self):
        if self.tile_mode not in ("exact", "fast"):
            raise ValueError("tile_mode must be 'exact' or 'fast'")
        if self.margin < 0:
            raise ValueError("margin must be >= 0 (0 = auto)")


def forgetting_margin(p1: int, p2: int, cmax: int = 255) -> int:
    """SGM's exponential-forgetting length: an upstream boundary state can
    influence L for at most ceil((Cmax + P2) / P1) pixels along the path."""
    return -(-(cmax + p2) // max(p1, 1))


def _to_dict(p) -> dict:
    d = dataclasses.asdict(p)
    d["__class__"] = type(p).__name__
    return d


_CLASSES = {"SGMParams": SGMParams, "FlowParams": FlowParams,
            "DistParams": DistParams}


def params_to_json(p) -> str:
    return json.dumps(_to_dict(p), indent=2, sort_keys=True)


def params_from_json(s: str):
    d = json.loads(s)
    cls = _CLASSES[d.pop("__class__")]
    for k, v in list(d.items()):
        if isinstance(v, list):
            d[k] = tuple(v)
    return cls(**d)


def load_preset(path: str):
    """Load a params preset from configs/*.json (may hold several params)."""
    with open(path) as f:
        d = json.load(f)
    out = {}
    for key, sub in d.items():
        if isinstance(sub, dict) and "__class__" in sub:
            out[key] = params_from_json(json.dumps(sub))
        else:
            out[key] = sub
    return out
