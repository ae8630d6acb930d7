"""latency_p95_ms (end to end, host clock): the 95th percentile, over
every call of the window (one frame each in the stream cells), of the time
from handing the pair to the entry point until its result is complete on
the device; numpy's linear interpolation."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95)) * 1e3
