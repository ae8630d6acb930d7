"""aggregate_roofline_pct.flow_batch: the reading of
aggregate_roofline_pct.batch, in the batched flow cells, which report
their rate as frames_per_s.flow_batch."""

from benchmark import spec


def read(run):
    return spec.load_metric("aggregate_roofline_pct.batch").read(run)
