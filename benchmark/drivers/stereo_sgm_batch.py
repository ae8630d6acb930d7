"""Driver "stereo_sgm_batch": fsgm_tpu_torch.stereo_sgm_batch over the
call's F frames, (F, H, W) uint8 pairs -> (F, H, W) float32 disparity."""

FRAME_AXIS = True


def build(cfg: dict):
    from fsgm_tpu_torch import SGMParams, stereo_sgm_batch

    from benchmark.spec import params_kwargs
    params = SGMParams(**params_kwargs(cfg))

    def call(left, right):
        return stereo_sgm_batch(left, right, params)
    return call
