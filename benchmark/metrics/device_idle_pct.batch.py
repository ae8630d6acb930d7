"""device_idle_pct.batch (device, device trace): 100 (1 - the union of the
device activity intervals / the profiled window)."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
