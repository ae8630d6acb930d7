"""plain_torch_ms.flow_batch: the reading of plain_torch_ms.batch, in the
batched flow cells, which report their rate as frames_per_s.flow_batch."""

from benchmark import spec


def read(run):
    return spec.load_metric("plain_torch_ms.batch").read(run)
