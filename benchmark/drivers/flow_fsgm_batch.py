"""Driver "flow_fsgm_batch": fsgm_tpu_torch.flow_fsgm_batch over the
call's F frames with the program's own chunk, (F, H, W) uint8 pairs ->
((F, H, W, 2) float32 flow, (F, H, W) bool validity)."""

FRAME_AXIS = True


def build(cfg: dict):
    from fsgm_tpu_torch import FlowParams, flow_fsgm_batch

    from benchmark.spec import params_kwargs
    params = FlowParams(**params_kwargs(cfg))

    def call(img1, img2):
        return flow_fsgm_batch(img1, img2, params)
    return call
