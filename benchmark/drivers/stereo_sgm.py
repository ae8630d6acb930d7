"""Driver "stereo_sgm": fsgm_tpu_torch.stereo_sgm on one frame, an (H, W)
uint8 pair -> (H, W) float32 disparity."""

FRAME_AXIS = False


def build(cfg: dict):
    from fsgm_tpu_torch import SGMParams, stereo_sgm

    from benchmark.spec import params_kwargs
    params = SGMParams(**params_kwargs(cfg))

    def call(left, right):
        return stereo_sgm(left, right, params)
    return call
