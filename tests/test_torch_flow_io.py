"""PyTorch port: its own copies of the JAX package's numpy modules.

fsgm_tpu_torch/io and fsgm_tpu_torch/eval.py copy what the port needs from
fsgm_tpu/io and fsgm_tpu/eval/metrics.py, so that the port imports nothing
of fsgm_tpu.  Held equal to the originals here: the synthetic generators
give the same arrays for the same seed, the writers write the same bytes,
load_gray reads the same pixels, and the metrics give the same numbers.
"""

import numpy as np
import pytest

from fsgm_tpu.eval import metrics as jmetrics
from fsgm_tpu.io import images as jimages
from fsgm_tpu.io import kitti as jkitti
from fsgm_tpu.io import synthetic as jsyn
from fsgm_tpu_torch import eval as teval
from fsgm_tpu_torch import io as tio


@pytest.mark.parametrize("name,args", [
    ("random_dot_stereo", (30, 50, 16)),
    ("constant_flow_pair", (24, 40, 3, -2)),
    ("constant_flow_sequence", (20, 36, 2, 1, 4)),
    ("blockwise_flow_pair", (32, 48, 5)),
])
@pytest.mark.parametrize("seed", [0, 11])
def test_generators_give_the_same_arrays(name, args, seed):
    want = getattr(jsyn, name)(*args, seed=seed)
    got = getattr(tio, name)(*args, seed=seed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _flow_and_valid(seed=0):
    rng = np.random.default_rng(seed)
    flow = rng.normal(0, 20, (9, 13, 2)).astype(np.float32)
    return flow, rng.random((9, 13)) > 0.3


@pytest.mark.parametrize("writer", ["disparity_png", "flow_png",
                                    "flow_png_no_valid", "flo", "pfm"])
def test_writers_write_the_same_bytes(tmp_path, writer):
    flow, valid = _flow_and_valid()
    disp = np.where(valid, np.abs(flow[..., 0]), -1.0).astype(np.float32)
    calls = {
        "disparity_png": ("write_disparity_png", (disp,), ".png"),
        "flow_png": ("write_flow_png", (flow, valid), ".png"),
        "flow_png_no_valid": ("write_flow_png", (flow,), ".png"),
        "flo": ("write_flo", (flow,), ".flo"),
        "pfm": ("write_pfm", (disp,), ".pfm"),
    }
    fn, args, suffix = calls[writer]
    ref_mod = jimages if writer == "pfm" else jkitti
    getattr(ref_mod, fn)(tmp_path / f"want{suffix}", *args)
    getattr(tio, fn)(tmp_path / f"got{suffix}", *args)
    assert (tmp_path / f"got{suffix}").read_bytes() == \
        (tmp_path / f"want{suffix}").read_bytes()


def test_load_gray_reads_the_same_pixels(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (17, 23), dtype=np.uint8)
    jimages.save_gray(tmp_path / "g.png", img)
    rgb = np.stack([img, img // 2, 255 - img], axis=-1)
    from PIL import Image
    Image.fromarray(rgb, mode="RGB").save(tmp_path / "c.png")
    for name in ("g.png", "c.png"):
        got = tio.load_gray(tmp_path / name)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jimages.load_gray(tmp_path / name))


def test_metrics_give_the_same_numbers():
    rng = np.random.default_rng(5)
    gt_d = rng.uniform(0, 60, (20, 30))
    pred_d = gt_d + rng.normal(0, 3, gt_d.shape)
    pred_d[rng.random(gt_d.shape) < 0.1] = -1
    assert teval.d1_all(pred_d, gt_d) == jmetrics.d1_all(pred_d, gt_d)
    gt_f = rng.normal(0, 10, (20, 30, 2))
    pred_f = gt_f + rng.normal(0, 3, gt_f.shape)
    valid_gt = rng.random((20, 30)) > 0.2
    pred_valid = rng.random((20, 30)) > 0.1
    for kw in ({}, dict(valid_gt=valid_gt, pred_valid=pred_valid)):
        assert teval.fl_all(pred_f, gt_f, **kw) == \
            jmetrics.fl_all(pred_f, gt_f, **kw)
