"""cost_ms.flow_batch: the reading of cost_ms.batch, in the
batched flow cells, which report their rate as frames_per_s.flow_batch."""

from benchmark import spec


def read(run):
    return spec.load_metric("cost_ms.batch").read(run)
