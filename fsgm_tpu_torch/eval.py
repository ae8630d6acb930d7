"""KITTI metrics, re-exported from the numpy-only fsgm_tpu.eval.metrics."""

from fsgm_tpu.eval.metrics import d1_all  # noqa: F401

__all__ = ["d1_all"]
