"""setup_s (end to end, host clock): from the run's first line to the
first timed call: imports, the CUDA context, loading (on a checkout's
first run: building) the kernels, the input pool and the warm-up calls."""


def read(run):
    return run.setup_s
