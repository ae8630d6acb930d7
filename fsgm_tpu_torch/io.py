"""Image readers and writers, re-exported from the numpy-only fsgm_tpu.io."""

from fsgm_tpu.io.images import load_gray, write_pfm  # noqa: F401
from fsgm_tpu.io.kitti import write_disparity_png  # noqa: F401
from fsgm_tpu.io.synthetic import random_dot_stereo  # noqa: F401

__all__ = ["load_gray", "write_pfm", "write_disparity_png",
           "random_dot_stereo"]
