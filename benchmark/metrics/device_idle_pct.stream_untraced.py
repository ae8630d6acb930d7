"""device_idle_pct.stream_untraced (device, device trace and host clock):
100 (1 - the device's busy seconds a frame in the profiled stretch / the
measured window's seconds a frame).  The profiler slows a launch-bound
stream's host, so device_idle_pct.stream counts its cost too; the device
work a frame does not change under it, and the window runs with the
profiler off, so this reading leaves that cost out."""


def read(run):
    if not run.frames_done:
        return None
    busy = run.trace.busy_s / run.trace.frames
    return 100.0 * (1.0 - busy * run.frames_done / run.window_s)
