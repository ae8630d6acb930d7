"""The aggregation floors (benchmark/work) by hand at KITTI shapes, and
that they read nothing of the program."""

import subprocess
import sys

from benchmark import spec
from benchmark.work import flow, stereo


def test_stereo_floor_by_hand():
    moved, ops = stereo.aggregate_work(spec.load_config("kitti_stereo"))
    label_pixels = 375 * 1242 * 128            # 59.6 M
    assert label_pixels == 59_616_000
    # u8 cost read once (max(24 bits, 255) fits a byte) and S written
    # once: 8 (255 + 100) = 2840 needs 16 bits
    assert moved == label_pixels * (1 + 2) == 178_848_000
    assert ops == label_pixels * 8 * 8 == 3_815_424_000


def test_flow_floor_by_hand():
    moved, ops = flow.aggregate_work(spec.load_config("kitti_flow"))
    # levels 375x1242, 187x621, 93x310, 46x155; the forward pass at every
    # level, the backward pass ("half") at levels 1-3; 81 labels each
    fwd = 375 * 1242 + 187 * 621 + 93 * 310 + 46 * 155
    bwd = 187 * 621 + 93 * 310 + 46 * 155
    label_pixels = (fwd + bwd) * 81
    assert moved == label_pixels * 3
    assert ops == label_pixels * 8 * 11
    assert [flow.passes({"fb_check": True, "fb_backward": m}, 0)
            for m in ("full", "cheap", "half", "single")] == [2, 2, 1, 2]
    assert flow.passes({"fb_check": False}, 2) == 1


def test_int_bytes_edges():
    assert [stereo.int_bytes(v) for v in (255, 256, 65535, 65536)] == \
        [1, 2, 2, 4]


def test_work_reads_nothing_of_the_program():
    code = ("import sys, benchmark.work.stereo, benchmark.work.flow; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=spec.ROOT).stdout
    assert "fsgm_tpu_torch" not in out and "torch" not in out
