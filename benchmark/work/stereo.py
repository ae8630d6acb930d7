"""Least work of SGM aggregation (K2, the sweep) for configuration kind
"stereo", from the configuration alone.

Bytes: the cost volume read once and S written once, each at the
narrowest integer width its range needs (a cost lies in [0, max(census
bits, invalid_cost)]; S over n paths in [0, n (max cost + P2)], since a
path's L never exceeds its cost plus P2).  Operations: 8 per label-pixel
and direction for the 1D label rule (three candidates formed with two
adds, three mins, the add of the cost and the subtraction of the previous
minimum, and its share of the running minimum).  Nothing here reads the
program: its launch plan, S dtype or kernel names do not move the floor.
"""

from __future__ import annotations

OPS_PER_LABEL_STEP = 8


def int_bytes(largest: int) -> int:
    """Bytes of the narrowest unsigned integer of 8, 16, 32 or 64 bits that
    holds [0, largest]."""
    for width in (1, 2, 4, 8):
        if largest < 1 << (8 * width):
            return width
    raise ValueError(f"{largest} needs more than 64 bits")


def cost_max(params: dict) -> int:
    ch, cw = params["census_window"]
    return max(ch * cw - 1, params["invalid_cost"])


def s_max(params: dict, paths: int) -> int:
    p2 = max(params["p2"], params["p1"] + 1)  # adaptive P2' stays below it
    return paths * (cost_max(params) + p2)


def aggregate_work(cfg: dict) -> tuple[int, int]:
    """(bytes, operations) of one frame's aggregation."""
    p = cfg["params"]
    paths = p["num_paths"]
    label_pixels = cfg["height"] * cfg["width"] * p["max_disp"]
    moved = label_pixels * (int_bytes(cost_max(p))
                            + int_bytes(s_max(p, paths)))
    return moved, label_pixels * paths * OPS_PER_LABEL_STEP
