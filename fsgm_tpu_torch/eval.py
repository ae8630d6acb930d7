"""KITTI metrics (numpy): D1-all for disparity, Fl-all for flow, with EPE
and density.  The port's own copy of fsgm_tpu/eval/metrics.py:

    bad = (err > 3 px) & (err > 5 % of |gt|), invalid predictions bad;
    D1-all / Fl-all = mean of bad over valid ground-truth pixels.
"""

from __future__ import annotations

import numpy as np


def d1_all(disp_pred: np.ndarray, disp_gt: np.ndarray,
           valid_gt: np.ndarray | None = None,
           tau_px: float = 3.0, tau_rel: float = 0.05) -> dict:
    """KITTI stereo metric.  Invalid predictions (<0) count as errors."""
    if valid_gt is None:
        valid_gt = disp_gt > 0
    pred_valid = disp_pred >= 0
    err = np.abs(disp_pred - disp_gt)
    bad = (err > tau_px) & (err > tau_rel * np.abs(disp_gt))
    bad = bad | ~pred_valid
    n = max(int(valid_gt.sum()), 1)
    return {
        "d1_all": float(bad[valid_gt].sum() / n),
        "epe": float(err[valid_gt & pred_valid].mean()) if
        (valid_gt & pred_valid).any() else float("inf"),
        "density": float(pred_valid[valid_gt].mean()),
    }


def fl_all(flow_pred: np.ndarray, flow_gt: np.ndarray,
           valid_gt: np.ndarray | None = None,
           tau_px: float = 3.0, tau_rel: float = 0.05,
           pred_valid: np.ndarray | None = None) -> dict:
    """KITTI flow metric.  flow_*: (H, W, 2).  ``pred_valid`` is the
    prediction's (H, W) validity plane (what flow_fsgm returns); without
    it every prediction counts as valid."""
    if valid_gt is None:
        valid_gt = np.ones(flow_gt.shape[:2], dtype=bool)
    if pred_valid is None:
        pred_valid = np.ones(flow_pred.shape[:2], dtype=bool)
    epe = np.sqrt(((flow_pred - flow_gt) ** 2).sum(-1))
    mag = np.sqrt((flow_gt ** 2).sum(-1))
    bad = (epe > tau_px) & (epe > tau_rel * mag)
    bad = bad | ~pred_valid
    n = max(int(valid_gt.sum()), 1)
    return {
        "fl_all": float(bad[valid_gt].sum() / n),
        "epe": float(epe[valid_gt & pred_valid].mean()) if
        (valid_gt & pred_valid).any() else float("inf"),
        "density": float(pred_valid[valid_gt].mean()),
    }
