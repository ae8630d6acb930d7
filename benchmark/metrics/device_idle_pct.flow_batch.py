"""device_idle_pct.flow_batch: the reading of device_idle_pct.batch, in the
batched flow cells, which report their rate as frames_per_s.flow_batch."""

from benchmark import spec


def read(run):
    return spec.load_metric("device_idle_pct.batch").read(run)
