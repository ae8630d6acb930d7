"""Driver "flow_fsgm": fsgm_tpu_torch.flow_fsgm on one frame, an (H, W)
uint8 pair -> ((H, W, 2) float32 flow, (H, W) bool validity)."""

FRAME_AXIS = False


def build(cfg: dict):
    from fsgm_tpu_torch import FlowParams, flow_fsgm

    from benchmark.spec import params_kwargs
    params = FlowParams(**params_kwargs(cfg))

    def call(img1, img2):
        return flow_fsgm(img1, img2, params)
    return call
