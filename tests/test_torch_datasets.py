"""PyTorch port: the KITTI devkit datasets (fsgm_tpu_torch/io/datasets.py)
and `cli kitti`, on a devkit tree the test writes.

  * iteration for 2012 and 2015, stereo and flow: each sample equal to
    what the JAX package's KittiStereoDataset / KittiFlowDataset load
    from the same tree, and to the written frames and ground truth;
  * a missing layout, an empty image directory and an unknown year raise;
  * `cli kitti stereo` and `cli kitti flow --device cpu`: each record
    equals the port's stereo_sgm / flow_fsgm scored by the port's eval,
    and the predictions are written in devkit naming.
"""

import json

import numpy as np
import pytest
import torch

from fsgm_tpu.io.datasets import KittiFlowDataset as JaxFlowDataset
from fsgm_tpu.io.datasets import KittiStereoDataset as JaxStereoDataset
from fsgm_tpu_torch import FlowParams, SGMParams, flow_fsgm, stereo_sgm
from fsgm_tpu_torch.cli.main import main
from fsgm_tpu_torch.eval import d1_all, fl_all
from fsgm_tpu_torch.io import (constant_flow_pair, random_dot_stereo,
                               read_disparity_png, read_flow_png, save_gray,
                               write_disparity_png, write_flow_png)
from fsgm_tpu_torch.io.datasets import (KittiFlowDataset,
                                        KittiStereoDataset)


def _make_stereo_tree(root, year, n=2, h=48, w=64, d=16):
    img1 = "image_2" if year == 2015 else "image_0"
    img2 = "image_3" if year == 2015 else "image_1"
    gt = "disp_occ_0" if year == 2015 else "disp_occ"
    tr = root / "training"
    for sub in (img1, img2, gt):
        (tr / sub).mkdir(parents=True)
    out = []
    for i in range(n):
        il, ir, dgt = random_dot_stereo(h, w, d, seed=i)
        save_gray(tr / img1 / f"{i:06d}_10.png", il)
        save_gray(tr / img2 / f"{i:06d}_10.png", ir)
        write_disparity_png(tr / gt / f"{i:06d}_10.png",
                            dgt.astype(np.float64))
        out.append((il, ir, dgt))
    return out


def _make_flow_tree(root, year, n=2, h=48, w=64):
    img = "image_2" if year == 2015 else "image_0"
    tr = root / "training"
    (tr / img).mkdir(parents=True)
    (tr / "flow_occ").mkdir(parents=True)
    out = []
    for i in range(n):
        i1, i2, fgt = constant_flow_pair(h, w, 2, -1, seed=i)
        save_gray(tr / img / f"{i:06d}_10.png", i1)
        save_gray(tr / img / f"{i:06d}_11.png", i2)
        write_flow_png(tr / "flow_occ" / f"{i:06d}_10.png", fgt,
                       np.ones((h, w), dtype=bool))
        out.append((i1, i2, fgt))
    return out


def _assert_same_sample(ours, want, fields):
    assert ours.name == want.name
    for f in fields:
        np.testing.assert_array_equal(getattr(ours, f), getattr(want, f))


@pytest.mark.parametrize("year", [2012, 2015])
def test_stereo_dataset_iteration(tmp_path, year):
    written = _make_stereo_tree(tmp_path, year)
    ds = KittiStereoDataset(tmp_path, year=year)
    want = JaxStereoDataset(tmp_path, year=year)
    assert len(ds) == len(want) == 2 and ds.ids == want.ids
    for i, (smp, ref) in enumerate(zip(ds, want)):
        _assert_same_sample(smp, ref, ("left", "right", "gt", "gt_valid"))
        il, ir, dgt = written[i]
        assert smp.name == f"{i:06d}"
        np.testing.assert_array_equal(smp.left, il)
        np.testing.assert_array_equal(smp.right, ir)
        np.testing.assert_allclose(smp.gt[smp.gt_valid], dgt[smp.gt_valid],
                                   atol=1 / 128)
    np.testing.assert_array_equal(ds[0].left, ds["000000"].left)


@pytest.mark.parametrize("year", [2012, 2015])
def test_flow_dataset_iteration(tmp_path, year):
    written = _make_flow_tree(tmp_path, year)
    ds = KittiFlowDataset(tmp_path, year=year)
    want = JaxFlowDataset(tmp_path, year=year)
    assert len(ds) == len(want) == 2
    for i, (smp, ref) in enumerate(zip(ds, want)):
        _assert_same_sample(smp, ref, ("img1", "img2", "gt", "gt_valid"))
        i1, i2, fgt = written[i]
        np.testing.assert_array_equal(smp.img1, i1)
        np.testing.assert_array_equal(smp.img2, i2)
        np.testing.assert_allclose(smp.gt, fgt, atol=1 / 32)
        assert smp.gt_valid.all()
    assert ds[1].name == "000001"


def test_missing_layout_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="layout not found"):
        KittiStereoDataset(tmp_path, year=2015)
    (tmp_path / "training" / "image_0").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="no '\\*_10.png' frames"):
        KittiFlowDataset(tmp_path, year=2012)
    with pytest.raises(ValueError, match="year"):
        KittiStereoDataset(tmp_path, year=2014)


def _records(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def test_cli_kitti_stereo_records_equal_the_port(tmp_path, capsys):
    _make_stereo_tree(tmp_path, 2015)
    outdir = tmp_path / "pred"
    assert main(["kitti", "stereo", str(tmp_path), "--max-disp", "16",
                 "--output-dir", str(outdir), "--device", "cpu"]) == 0
    recs = _records(capsys)
    p = SGMParams(max_disp=16)
    for rec, smp in zip(recs[:-1], KittiStereoDataset(tmp_path)):
        disp = stereo_sgm(torch.tensor(smp.left), torch.tensor(smp.right),
                          p).numpy()
        assert rec["frame"] == smp.name and rec["wall_s"] >= 0
        assert {k: v for k, v in rec.items() if k not in (
            "frame", "wall_s")} == d1_all(disp, smp.gt.astype(np.float64),
                                          smp.gt_valid)
        pred = read_disparity_png(outdir / f"{smp.name}_10.png")
        np.testing.assert_array_equal(pred < 0, disp < 0)
        assert np.abs(pred - disp)[disp >= 0].max() <= 1 / 256
    summary = recs[-1]
    assert summary["cmd"] == "kitti" and summary["task"] == "stereo"
    assert summary["frames"] == summary["scored"] == 2
    assert summary["d1_all"] == round(
        float(np.mean([r["d1_all"] for r in recs[:-1]])), 4)
    assert summary["d1_all"] < 0.30 and "mean_wall_s" in summary


def test_cli_kitti_flow_records_equal_the_port(tmp_path, capsys):
    _make_flow_tree(tmp_path, 2012, n=1)
    outdir = tmp_path / "pred"
    assert main(["kitti", "flow", str(tmp_path), "--year", "2012",
                 "--output-dir", str(outdir), "--device", "cpu"]) == 0
    recs = _records(capsys)
    smp = KittiFlowDataset(tmp_path, year=2012)[0]
    flow, valid = flow_fsgm(torch.tensor(smp.img1), torch.tensor(smp.img2),
                            FlowParams())
    flow, valid = flow.numpy(), valid.numpy()
    assert {k: v for k, v in recs[0].items() if k not in (
        "frame", "wall_s")} == fl_all(flow, smp.gt, smp.gt_valid,
                                      pred_valid=valid)
    pred, pred_valid = read_flow_png(outdir / "000000_10.png")
    np.testing.assert_array_equal(pred_valid, valid)
    assert np.abs(pred - flow)[valid].max() <= 1 / 64
    assert recs[-1]["scored"] == 1 and recs[-1]["fl_all"] == round(
        recs[0]["fl_all"], 4)
