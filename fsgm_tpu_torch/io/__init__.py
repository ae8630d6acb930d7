"""Image and result I/O of the port (numpy): the port's own copies of the
readers, writers and synthetic generators of fsgm_tpu/io."""

from fsgm_tpu_torch.io.images import (load_gray, read_pfm, read_pgm,
                                      save_gray, write_pfm, write_pgm)
from fsgm_tpu_torch.io.kitti import (read_disparity_png, read_flo,
                                     read_flow_png, read_png16,
                                     write_disparity_png, write_flo,
                                     write_flow_png, write_png16)
from fsgm_tpu_torch.io.synthetic import (blockwise_flow_pair,
                                         constant_flow_pair,
                                         constant_flow_sequence,
                                         fractional_flow_pair,
                                         fractional_shift_stereo,
                                         random_dot_stereo)

__all__ = ["load_gray", "save_gray", "read_pgm", "write_pgm", "read_pfm",
           "write_pfm", "read_disparity_png",
           "read_flo", "read_flow_png", "read_png16", "write_disparity_png",
           "write_flo", "write_flow_png", "write_png16",
           "blockwise_flow_pair", "constant_flow_pair",
           "constant_flow_sequence", "fractional_flow_pair",
           "fractional_shift_stereo", "random_dot_stereo"]
