"""Execution over several devices: tiled stereo and flow over a grid of
devices (frame shards x row tiles x column tiles), with the frame shards
over torch.distributed ranks given a RankMesh, and the disparity axis
sharded over devices; the counterpart of fsgm_tpu/parallel."""

from fsgm_tpu_torch.parallel.disparity_sharded import stereo_sgm_dsharded
from fsgm_tpu_torch.parallel.multihost import (RankMesh, global_mesh,
                                               init_distributed,
                                               weak_scaling_report)
from fsgm_tpu_torch.parallel.tiled import (stereo_sgm_sharded,
                                           stereo_sgm_sharded_reference)
from fsgm_tpu_torch.parallel.tiled_flow import flow_fsgm_sharded

__all__ = ["stereo_sgm_sharded", "stereo_sgm_sharded_reference",
           "flow_fsgm_sharded", "stereo_sgm_dsharded", "RankMesh",
           "global_mesh", "init_distributed", "weak_scaling_report"]
