"""fsgm_tpu_torch — SGM stereo and fSGM optical flow in PyTorch with
hand-written Hopper kernels.

The PyTorch/CUDA port of fsgm_tpu (which stays the reference).  Public API:

    from fsgm_tpu_torch import stereo_sgm, SGMParams, flow_fsgm, FlowParams

    disp = stereo_sgm(img_l, img_r, SGMParams(max_disp=128))  # (H, W) uint8 tensors
    flow, valid = flow_fsgm(img1, img2, FlowParams())
    disp = stereo_sgm_sharded(imgs_l, imgs_r, params,
                              DistParams(tiles_y=4))  # (F, H, W) row tiles

CUDA tensors run the kernels in csrc/ (built with nvcc at first use); CPU
tensors run their plain PyTorch versions.
"""

from fsgm_tpu_torch.params import (DIRS_8, DIRS_16, INVALID, DistParams,
                                   FlowParams, SGMParams, load_preset)
from fsgm_tpu_torch.models.flow import (flow_fsgm, flow_fsgm_batch,
                                        flow_fsgm_reference, flow_sequence)
from fsgm_tpu_torch.models.stereo import (stereo_sgm, stereo_sgm_batch,
                                          stereo_sgm_batch_reference,
                                          stereo_sgm_reference)
from fsgm_tpu_torch.parallel import (flow_fsgm_sharded, stereo_sgm_sharded,
                                     stereo_sgm_sharded_reference)

__all__ = ["SGMParams", "FlowParams", "DistParams", "DIRS_8", "DIRS_16",
           "INVALID", "load_preset", "stereo_sgm", "stereo_sgm_batch",
           "stereo_sgm_batch_reference", "stereo_sgm_reference", "flow_fsgm",
           "flow_fsgm_batch", "flow_fsgm_reference", "flow_sequence",
           "stereo_sgm_sharded", "stereo_sgm_sharded_reference",
           "flow_fsgm_sharded"]
