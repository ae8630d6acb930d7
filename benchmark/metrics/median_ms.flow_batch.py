"""median_ms.flow_batch: the reading of median_ms.batch, in the
batched flow cells, which report their rate as frames_per_s.flow_batch."""

from benchmark import spec


def read(run):
    return spec.load_metric("median_ms.batch").read(run)
