"""latency_p50_ms (end to end, host clock): the median of the samples of
latency_p95_ms."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 50)) * 1e3
