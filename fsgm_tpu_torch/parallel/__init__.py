"""Tiled execution over a grid of devices in one process: frame shards x
row tiles (x column tiles for stereo), the counterpart of
fsgm_tpu/parallel's tiled stereo and flow."""

from fsgm_tpu_torch.parallel.tiled import (stereo_sgm_sharded,
                                           stereo_sgm_sharded_reference)
from fsgm_tpu_torch.parallel.tiled_flow import flow_fsgm_sharded

__all__ = ["stereo_sgm_sharded", "stereo_sgm_sharded_reference",
           "flow_fsgm_sharded"]
