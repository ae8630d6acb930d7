"""The comparison that decides a run's ``correct``: the program's outputs
of the sampled calls against the plain reference's, pixel by pixel.

A pixel is mismatched where any output differs from the reference's at
it, bit for bit (every channel of a flow vector, the validity plane, a
disparity and its invalid mark).  The integer stages of SGM are exact and
the float tail is the same float32 arithmetic on both sides, so the limit
on ``mismatched_px`` is 0 (PERF.md gives the readings it was set from).
"""

from __future__ import annotations

import torch


def mismatch(got: tuple, want: tuple) -> torch.Tensor:
    """(F, H, W) bool: where any of the outputs differs from the
    reference's; every pixel of a frame whose outputs differ in shape."""
    lead = want[0].shape[:3]
    bad = torch.zeros(lead, dtype=torch.bool, device=want[0].device)
    if len(got) != len(want):
        return ~bad
    for g, r in zip(got, want):
        if tuple(g.shape) != tuple(r.shape):
            return ~bad
        d = g.to(r.device) != r
        bad |= d.reshape(lead + (-1,)).any(-1)
    return bad


def checks(got: tuple, want: tuple, limits: dict) -> tuple[dict, int]:
    """({name: {"value", "limit"}}, frames with a mismatched pixel)."""
    bad = mismatch(got, want)
    found = {"mismatched_px": int(bad.sum())}
    return ({k: {"value": v, "limit": limits[k]} for k, v in found.items()},
            int(bad.reshape(bad.shape[0], -1).any(1).sum()))
