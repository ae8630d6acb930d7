"""launches_per_frame.stream (models, device trace): device kernels,
memsets and copies of the profiled window a frame."""


def read(run):
    return run.trace.launches / run.trace.frames
