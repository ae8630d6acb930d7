"""latency_p50_ms.stream (models, host clock): the median of the samples
of latency_p95_ms, every call of the window, numpy's linear interpolation.
Per layer, not end to end: the host that paces the stream cell switches
between a fast and a slow state about once a second, so the median follows
the share of each state in a run, while the 95th percentile reads the slow
state alone."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(run.latencies_s, 50)) * 1e3
