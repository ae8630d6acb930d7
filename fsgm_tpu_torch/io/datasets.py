"""KITTI 2012/2015 devkit directory trees as datasets (numpy).

The port's own copy of fsgm_tpu/io/datasets.py: the same layout rules,
samples and errors, reading through the port's io codecs.

    ds = KittiStereoDataset("/data/kitti2015", year=2015)
    for sample in ds:
        disp = stereo_sgm(torch.from_numpy(sample.left).cuda(),
                          torch.from_numpy(sample.right).cuda(), params)
        metrics = d1_all(disp.cpu().numpy(), sample.gt, sample.gt_valid)

Layouts (KITTI devkit conventions):
  2012 stereo:   {split}/image_0/{id}_10.png (left grayscale),
                 image_1 (right), disp_occ / disp_noc (GT, training only)
  2015 stereo:   {split}/image_2/{id}_10.png (left color),
                 image_3 (right), disp_occ_0 / disp_noc_0
  2012 flow:     {split}/image_0/{id}_10.png + {id}_11.png,
                 flow_occ / flow_noc
  2015 flow:     {split}/image_2/{id}_10.png + {id}_11.png,
                 flow_occ / flow_noc

Images load as grayscale uint8 (color PNGs by luma); ground truth loads
through io/kitti.py.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from fsgm_tpu_torch.io import kitti
from fsgm_tpu_torch.io.images import load_gray


@dataclasses.dataclass
class StereoSample:
    name: str
    left: np.ndarray                      # (H, W) uint8
    right: np.ndarray
    gt: np.ndarray | None                 # (H, W) float32, -1 = invalid
    gt_valid: np.ndarray | None           # (H, W) bool


@dataclasses.dataclass
class FlowSample:
    name: str
    img1: np.ndarray                      # (H, W) uint8
    img2: np.ndarray
    gt: np.ndarray | None                 # (H, W, 2) float32
    gt_valid: np.ndarray | None           # (H, W) bool


def _image_dirs(year: int, kind: str):
    """(first_dir, second_dir) of input images for the benchmark year."""
    if year == 2012:
        return ("image_0", "image_1") if kind == "stereo" \
            else ("image_0", "image_0")
    if year == 2015:
        return ("image_2", "image_3") if kind == "stereo" \
            else ("image_2", "image_2")
    raise ValueError(f"year must be 2012 or 2015, got {year}")


def _gt_dir(year: int, kind: str, occ: bool) -> str:
    tag = "occ" if occ else "noc"
    if kind == "stereo":
        return f"disp_{tag}_0" if year == 2015 else f"disp_{tag}"
    return f"flow_{tag}"


class _KittiDataset:
    """Directory iteration shared by both tasks: frame ids follow the
    devkit's '{id:06d}_10.png' naming; ground truth exists only in
    training splits."""

    kind = ""

    def __init__(self, root, year: int = 2015, split: str = "training",
                 occ: bool = True):
        self.root = Path(root) / split
        self.year, self.occ = year, occ
        d1, d2 = _image_dirs(year, self.kind)
        self.dir1, self.dir2 = self.root / d1, self.root / d2
        self.gt_dir = self.root / _gt_dir(year, self.kind, occ)
        if not self.dir1.is_dir():
            raise FileNotFoundError(
                f"KITTI {year} {self.kind} layout not found under "
                f"{self.root} (expected {self.dir1})")
        self.ids = sorted(p.name[:-7]                # strip '_10.png'
                          for p in self.dir1.glob("*_10.png"))
        if not self.ids:
            raise FileNotFoundError(f"no '*_10.png' frames in {self.dir1}")

    def __len__(self) -> int:
        return len(self.ids)

    def __iter__(self):
        for fid in self.ids:
            yield self[fid]

    def __getitem__(self, fid):
        if isinstance(fid, int):
            fid = self.ids[fid]
        return self._load(fid)


class KittiStereoDataset(_KittiDataset):
    """KITTI 2012/2015 stereo: left/right pair + GT disparity (training)."""

    kind = "stereo"

    def _load(self, fid: str) -> StereoSample:
        left = load_gray(self.dir1 / f"{fid}_10.png")
        right = load_gray(self.dir2 / f"{fid}_10.png")
        gt = gt_valid = None
        gt_path = self.gt_dir / f"{fid}_10.png"
        if gt_path.exists():
            gt = kitti.read_disparity_png(gt_path)
            gt_valid = gt > 0
        return StereoSample(fid, left, right, gt, gt_valid)


class KittiFlowDataset(_KittiDataset):
    """KITTI 2012/2015 flow: frame-10/11 pair + GT flow (training)."""

    kind = "flow"

    def _load(self, fid: str) -> FlowSample:
        img1 = load_gray(self.dir1 / f"{fid}_10.png")
        img2 = load_gray(self.dir2 / f"{fid}_11.png")
        gt = gt_valid = None
        gt_path = self.gt_dir / f"{fid}_10.png"
        if gt_path.exists():
            gt, gt_valid = kitti.read_flow_png(gt_path)
        return FlowSample(fid, img1, img2, gt, gt_valid)
