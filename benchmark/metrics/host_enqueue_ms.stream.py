"""host_enqueue_ms.stream (models, host clock): the median over the traced
run's enqueue calls (profiler off, before the profiled stretch) of the
host ms from the entry call to its return, before the synchronise, a
frame."""

import statistics


def read(run):
    if not run.enqueue_s:
        return None
    return statistics.median(run.enqueue_s) * 1e3 / run.frames_per_call
