"""census_ms.flow_batch: the reading of census_ms.batch, in the
batched flow cells, which report their rate as frames_per_s.flow_batch."""

from benchmark import spec


def read(run):
    return spec.load_metric("census_ms.batch").read(run)
