"""Least work of fSGM aggregation (K2 with the 2D label rule) for
configuration kind "flow", from the configuration alone.

Summed over the pyramid levels (level k is H >> k by W >> k, each halving
floored) and over the passes each level runs: the forward pass at every
level, the backward pass where the forward-backward check runs it
(``fb_backward`` "full": every level; "half": levels 1 and up; "single":
one more pass at level 0; "cheap" as "full").  Each pass aggregates the
(2r+1)^2 labels the configuration searches, not the slots a program pads
them to.  Bytes and the 8 paths as in work/stereo.py; operations 11 per
label-pixel and direction (the 2D rule's four-neighbour minimum costs
three more than the 1D rule's two).
"""

from __future__ import annotations

from benchmark.work.stereo import cost_max, int_bytes, s_max

OPS_PER_LABEL_STEP = 11
PATHS = 8


def passes(params: dict, level: int) -> int:
    """Aggregation passes at pyramid level ``level``."""
    if not params["fb_check"]:
        return 1
    mode = params["fb_backward"]
    if mode in ("full", "cheap"):
        return 2
    if mode == "half":
        return 2 if level >= 1 else 1
    if mode == "single":
        return 2 if level == 0 else 1
    raise ValueError(f"unknown fb_backward {mode!r}")


def aggregate_work(cfg: dict) -> tuple[int, int]:
    """(bytes, operations) of one frame's aggregation."""
    p = cfg["params"]
    labels = (2 * p["search_radius"] + 1) ** 2
    h, w = cfg["height"], cfg["width"]
    label_pixels = 0
    for level in range(p["levels"]):
        label_pixels += passes(p, level) * h * w * labels
        h, w = h // 2, w // 2
    moved = label_pixels * (int_bytes(cost_max(p))
                            + int_bytes(s_max(p, PATHS)))
    return moved, label_pixels * PATHS * OPS_PER_LABEL_STEP
