"""Timing of one call on the card, shared by chip_smoke.py and the kernel
benches (utils/k13_bench.py, utils/k4_bench.py).

  * ``median_ms``: the median over ``reps`` of one call's CUDA-event ms,
    after ``warmup`` calls (``inner`` calls back to back a timing): what a
    caller waits for, the wrapper's host work included where it outlasts
    the kernel;
  * ``device_profile`` / ``device_ms``: torch.profiler's device time of one
    call, the kernels' own, or None where no profile recorded a launch;
  * ``device_total``: the same summed over every activity of a call that
    launches a kernel name many times (utils/flow_cost_bench.py).

The module imports nothing of the package, so that a bench run on another
tree of the port (``--root``) loads this file from its own tree by its
path and times both trees with the same code.
"""

from __future__ import annotations

# Profiles taken before device_profile gives up: on the card a whole
# torch.profiler profile now and then records no device launch at all.
PROFILE_ATTEMPTS = 3


def median_ms(fn, reps: int = 10, warmup: int = 2, inner: int = 1) -> float:
    """Median over reps of the ms of one fn() call, timed by CUDA events
    over ``inner`` calls back to back."""
    import numpy as np
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def _device_rows(fn, reps: int, warmup: int) -> list:
    """torch.profiler's device rows (key_averages) of ``reps`` fn() calls
    after ``warmup`` calls; a profile that records no device launch is
    taken again, up to PROFILE_ATTEMPTS profiles ([] if none recorded
    one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    rows = []
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count]
        if rows:
            break
    return rows


def device_profile(fn, reps: int = 10, warmup: int = 1):
    """torch.profiler's device time of one fn() call for a fn that launches
    each of its kernels once: (the sum over its kernels of their mean
    duration over ``reps`` calls, the launches the profile recorded a call,
    the kernels' names).  The mean is over the recorded launches: a
    profile may miss some ((None, 0.0, []) if no profile recorded one: no
    time was measured)."""
    rows = _device_rows(fn, reps, warmup)
    if not rows:
        return None, 0.0, []
    return (sum(e.self_device_time_total / e.count for e in rows) / 1e3,
            sum(e.count for e in rows) / reps,
            sorted({e.key[:60] for e in rows}))


def device_total(fn, reps: int = 10, warmup: int = 1):
    """torch.profiler's device time of one fn() call summed over every
    activity it launches, however often a kernel's name recurs (a plain
    PyTorch stage), and the activities a call: (ms, launches), (None, 0.0)
    if no profile recorded one."""
    rows = _device_rows(fn, reps, warmup)
    if not rows:
        return None, 0.0
    return (sum(e.self_device_time_total for e in rows) / 1e3 / reps,
            sum(e.count for e in rows) / reps)


def device_ms(fn, reps: int = 10, warmup: int = 1) -> float | None:
    """device_profile's device ms of one fn() call (None: not recorded)."""
    return device_profile(fn, reps, warmup)[0]
