"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line's contents.

Set-up (``setup_s``, from the process's first line to the first timed
call): importing the program through the cell's driver, the pool of
inputs made on the device from the seed by the traffic's generator, and
warm-up calls of the cell's one shape, which load (on a checkout's first
run: build) the program's kernels and fill PyTorch's caching allocator
with the blocks the window will use.

The window is a closed loop over the pool with ``in_flight`` calls
outstanding: a call is issued, and once ``in_flight`` are queued the
oldest is waited for (a CUDA event recorded after it), its latency taken
from its issue to its completion.  With 1 in flight each call is waited
for before the next (a camera's stream); with 2 the host queues the next
call while the device works on the last (an offline consumer).  The window
ends at the first completion at or after ``seconds``, so it holds whole
calls and all their time.  ``check_calls`` of its completed calls, drawn
from the seed by reservoir sampling, keep their outputs for the
comparison.

A traced run (trace on) then times ``enqueue_calls`` calls from entry to
return with the profiler off, and profiles ``profile_calls`` calls
(devtrace.profile).  After the peak memory is read and the program's
state freed, the reference computes the sampled calls' frames and
compare.checks decides ``correct``.  The guard against the JAX package
(guard.FORBIDDEN) looks after set-up, when the window has closed, and
once more when the reference and the metrics have run, before the result.

A cell may ask for several cards (``chips``).  This process and its card
(rank 0) are all the harness sees: a multi-card cell's traced per-layer
metrics and breakdown cover rank 0 alone.  The driver owns the processes
it starts on the other cards, and two optional functions of its module
serve them, each called only where the module defines it:
``memory_peak_bytes(call)`` gives one peak a card, rank 0's among them,
and the result reports as ``device.count`` the cards whose peak is above
0 and as ``memory_peak_bytes`` the largest (without it: one card, this
process's own peak); then ``close(call)``, called once after the traced
stretch and before the program's state is freed, ends those processes, so
that the reference runs on a quiet card and the run exits cleanly.  A
driver whose run fails before ``close`` ends them when this process exits.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import itertools
import random
import statistics
import sys
import time

import torch

from benchmark import compare, devtrace, guard, spec


class ForbiddenModule(RuntimeError):
    """A module the benchmark may not load (guard.FORBIDDEN) is loaded."""


@dataclasses.dataclass
class Run:
    """What a metric's reader sees of a run."""
    cell: str
    cfg: dict
    traffic: dict
    frames_per_call: int
    card: str
    setup_s: float
    window_s: float = 0.0
    frames_done: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    enqueue_s: list = dataclasses.field(default_factory=list)
    trace: devtrace.Trace | None = None
    peaks: dict | None = None


def log(*parts) -> None:
    print("#", *parts, file=sys.stderr, flush=True)


def check_guard(when: str) -> None:
    found = guard.forbidden_loaded()
    if found:
        raise ForbiddenModule(f"loaded {when}: {found}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(device: torch.device):
    """A marker of the work queued so far (None on the CPU, where a call
    returns finished)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def _wait(mark) -> None:
    if mark is not None:
        mark.synchronize()


def outputs(out, frame_axis: bool) -> tuple:
    """A driver's outputs as a tuple of tensors with a frame axis."""
    out = out if isinstance(out, tuple) else (out,)
    return out if frame_axis else tuple(o[None] for o in out)


def make_pool(cfg: dict, traffic: dict, seed: int, device: torch.device):
    """The cell's pool_calls x frames_per_call pairs, (P F, H, W) uint8 each,
    made on ``device`` from the seed by the traffic's generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    made = spec.load_generator(traffic["generator"]).make(
        traffic["frames_per_call"] * traffic["pool_calls"], cfg, gen,
        **traffic.get("generator_args", {}))
    return made[0], made[1]


def _window(call, inputs: list, run: Run, seconds: float, in_flight: int,
            n_check: int, rng: random.Random, device) -> list:
    """The measured window (module docstring): the latencies and counts go
    into ``run``; returns the sampled calls' (pool index, outputs)."""
    kept: list = []  # reservoir of (pool index, outputs)
    pending: collections.deque = collections.deque()
    issued = done = 0
    start = time.perf_counter()
    while True:
        t_call = time.perf_counter()
        pending.append((t_call, issued % len(inputs),
                        call(*inputs[issued % len(inputs)]), _mark(device)))
        issued += 1
        if len(pending) < in_flight:
            continue
        t_call, k, out, mark = pending.popleft()
        _wait(mark)
        t_done = time.perf_counter()
        run.latencies_s.append(t_done - t_call)
        if done < n_check:
            kept.append((k, out))
        elif (j := rng.randrange(done + 1)) < n_check:
            kept[j] = (k, out)
        del out
        done += 1
        if t_done - start >= seconds:
            break
    for *_, mark in pending:  # issued in the window, completed after it
        _wait(mark)
    run.window_s = t_done - start
    run.frames_done = done * run.frames_per_call
    lat = sorted(run.latencies_s)
    thirds = [sorted(run.latencies_s[k * done // 3:(k + 1) * done // 3])
              for k in range(3)]
    log(f"window {run.window_s:.6f} s: {done} calls, {run.frames_done} "
        f"frames, {in_flight} in flight; setup_s {run.setup_s:.6f}; call ms "
        "deciles " + " ".join(f"{lat[min(done - 1, d * done // 10)] * 1e3:.3f}"
                              for d in range(11))
        + "; medians of the window's thirds " + " ".join(
            f"{t[len(t) // 2] * 1e3:.3f}" for t in thirds if t))
    return kept


def _traced(call, inputs: list, run: Run, in_flight: int, device):
    """The traced run's readings after the window: the host's enqueue time
    with the profiler off, then the profiled stretch twice, lean (the
    metrics) and with host operations (the breakdown, returned)."""
    for j in range(run.traffic["enqueue_calls"]):
        t_call = time.perf_counter()
        out = call(*inputs[j % len(inputs)])
        run.enqueue_s.append(time.perf_counter() - t_call)
        _sync(device)
        del out
    order = itertools.count()

    def traced_call():  # waited for as the window waits for it
        out = call(*inputs[next(order) % len(inputs)])
        if in_flight == 1:
            _wait(_mark(device))
        return out
    stretch = (traced_call, run.traffic["profile_calls"],
               run.frames_per_call, spec.kernel_stages())
    run.trace = devtrace.profile(*stretch)
    labelled = devtrace.profile(*stretch, host_ops=True)
    run.peaks = spec.peaks(run.card)
    untraced = statistics.median(run.latencies_s) / run.frames_per_call
    log(f"instrumentation: {run.trace.window_s / run.trace.frames * 1e3:.4f}"
        f" ms a frame traced ({run.trace.window_from}), "
        f"{labelled.window_s / labelled.frames * 1e3:.4f} with host "
        f"operations, {untraced * 1e3:.4f} untraced (median call)")
    return labelled.breakdown()


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float) -> dict:
    """Everything of a run after the look for the chips; t0 is the
    process's first perf_counter reading."""
    bench = spec.load_benchmark()
    cell = spec.cell(bench, name)
    cfg = spec.load_config(cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    driver = spec.load_driver(traffic["driver"])
    frames = traffic["frames_per_call"]
    pool = traffic["pool_calls"]
    if not driver.FRAME_AXIS and frames != 1:
        raise ValueError(f"driver {traffic['driver']} takes one frame a call")
    call = driver.build(cfg)
    marks = [("program imported", time.perf_counter())]
    imgs_a, imgs_b = make_pool(cfg, traffic, seed, device)
    _sync(device)
    marks.append(("inputs made", time.perf_counter()))
    inputs = [(imgs_a[k * frames:(k + 1) * frames],
               imgs_b[k * frames:(k + 1) * frames]) if driver.FRAME_AXIS
              else (imgs_a[k], imgs_b[k]) for k in range(pool)]
    n_check, in_flight = traffic["check_calls"], traffic["in_flight"]
    # as many outputs alive at once as the window keeps
    held = [call(*inputs[k % pool]) for k in range(
        max(traffic["warmup_calls"], n_check + in_flight))]
    _sync(device)
    del held
    marks.append(("warmed up", time.perf_counter()))
    log("set-up: " + ", ".join(f"{what} at {t - t0:.3f} s"
                               for what, t in marks))
    check_guard("after set-up")
    run = Run(name, cfg, traffic, frames,
              torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu", time.perf_counter() - t0)

    kept = _window(call, inputs, run, seconds, in_flight, n_check,
                   random.Random(seed), device)
    breakdown = _traced(call, inputs, run, in_flight, device) if trace \
        else None
    if hasattr(driver, "memory_peak_bytes"):
        # one peak a card the call used: the cards it left untouched read 0
        peaks = [p for p in driver.memory_peak_bytes(call) if p > 0]
    else:
        peaks = [torch.cuda.max_memory_allocated(device)
                 if device.type == "cuda" else 0]
    if hasattr(driver, "close"):
        driver.close(call)
    check_guard("when the window closed")

    # the program's state goes before the reference runs
    ref_idx = torch.tensor([k for k, _ in kept], device=device)
    got = tuple(torch.cat(parts) for parts in zip(
        *(outputs(out, driver.FRAME_AXIS) for _, out in kept)))
    sel_a = imgs_a.view(pool, frames, *imgs_a.shape[1:])[ref_idx].flatten(0, 1)
    sel_b = imgs_b.view(pool, frames, *imgs_b.shape[1:])[ref_idx].flatten(0, 1)
    del call, inputs, kept, imgs_a, imgs_b, driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = spec.load_reference(cfg["kind"]).run(sel_a, sel_b, cfg)
    checks, failed = compare.checks(got, want, cfg["limits"])
    log(f"reference over {sel_a.shape[0]} frames of {len(ref_idx)} sampled "
        f"calls: {time.perf_counter() - t_ref:.3f} s")

    metrics = {}
    for m in spec.metrics_for(bench, name, trace):
        value = spec.load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.card, "count": len(peaks),
           "memory_peak_bytes": max(peaks, default=0)}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": run.frames_done, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown
        log(f"traced {run.trace.frames} frames: {run.trace.launches} device "
            f"activities, busy {run.trace.busy_s:.6f} of "
            f"{run.trace.window_s:.6f} s")
    result["checks"] = checks
    # the reference and the metrics' readers ran after the window's check
    check_guard("before the result")
    return result
