"""The device trace of a short profiled stretch of calls, and the readings
the per-layer metrics take from it.

``profile`` runs ``calls`` calls of the entry point under torch.profiler
(CUDA activity, and with ``host_ops`` PyTorch's host operations), inside
one span named WINDOW_SPAN that
ends after the device has finished, exports the Chrome trace to a file
under TMPDIR, reads it back and deletes it.  A profile that records no
device kernel is taken again (torch.profiler on the card now and then
records none), up to ATTEMPTS profiles, each empty one logged on standard
error; after that the run fails rather than report a device time of 0.

The profiled window is the WINDOW_SPAN's extent on the host clock, to
which the trace aligns the device timestamps.  ``Trace.busy_s`` is the
union of the device activity intervals (kernels, copies, memsets) inside
it, so overlapping work on several streams counts once.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import sys
import tempfile

WINDOW_SPAN = "benchmark.profiled"
CALL_SPAN = "benchmark.call"
SYNC_SPAN = "benchmark.sync"
ATTEMPTS = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10  # entries of each breakdown list


class NoDeviceActivity(RuntimeError):
    """No profile of the stretch recorded a device kernel."""


def kernel_base(name: str) -> str:
    """A kernel's function name without return type, namespaces, template
    arguments or parameters: 'void fsgm_k2::sgm_sweep_kernel<int>(...)' ->
    'sgm_sweep_kernel'."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void\s+", "", name)
    cut = min((i for i in (name.find("<"), name.find("(")) if i >= 0),
              default=len(name))
    return name[:cut].split("::")[-1].strip()


class Trace:
    """Device and host events of one profiled stretch, in seconds."""

    def __init__(self, events: list[dict], frames: int, stages: dict):
        self.frames = frames
        self.stages = stages
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == WINDOW_SPAN]
        if len(spans) > 1:
            raise ValueError(f"{len(spans)} spans {WINDOW_SPAN!r} in trace")
        if spans:
            self.window_from = WINDOW_SPAN
        else:  # no host operations recorded: the runtime calls' extent
            spans = [{"ts": min(e["ts"] for e in events
                                if e.get("cat") == "cuda_runtime"),
                      "tid": None}]
            spans[0]["dur"] = max(e["ts"] + e["dur"] for e in events
                                  if e.get("cat") == "cuda_runtime") \
                - spans[0]["ts"]
            self.window_from = "runtime calls"
        self.start = spans[0]["ts"] * 1e-6
        self.end = self.start + spans[0]["dur"] * 1e-6
        runtime_at = {e["args"]["correlation"]: e["ts"] * 1e-6
                      for e in events if e.get("cat") == "cuda_runtime"
                      and "correlation" in e.get("args", {})}
        # the benchmark's thread: its host events nest, each inside its
        # parent (the enclosing event, or -1)
        self.host = sorted(
            ((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"],
              e["cat"]) for e in events if e.get("cat") in HOST_CATS
             and e.get("tid") == spans[0].get("tid")
             and e["ts"] * 1e-6 < self.end
             and (e["ts"] + e["dur"]) * 1e-6 > self.start),
            key=lambda h: (h[0], -h[1]))
        self._starts = [h[0] for h in self.host]
        self._parent, stack = [], []
        for i, (t0, *_) in enumerate(self.host):
            while stack and self.host[stack[-1]][1] < t0:
                stack.pop()
            self._parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self.device = []  # (start, end, cat, name, launching host time)
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            t0 = e["ts"] * 1e-6
            t1 = t0 + e.get("dur", 0) * 1e-6
            if t1 > self.start and t0 < self.end:
                launch = runtime_at.get(e.get("args", {}).get("correlation"))
                self.device.append((t0, t1, e["cat"], e["name"], launch))
        self.device.sort()

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def merged(self) -> list[tuple[float, float]]:
        """The union of the device intervals, clipped to the window."""
        out: list[list[float]] = []
        for t0, t1, *_ in self.device:
            t0, t1 = max(t0, self.start), min(t1, self.end)
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged())

    @property
    def launches(self) -> int:
        return len(self.device)

    def stage(self, name: str) -> str | None:
        """The hand-written kernel stage of a device activity, or None for
        PyTorch's own kernels, copies and memsets."""
        return self.stages.get(kernel_base(name))

    def kernel_s(self, stage: str | None) -> float:
        """Device seconds of the kernels of ``stage`` (None: every kernel
        that is not hand-written)."""
        return sum(t1 - t0 for t0, t1, cat, name, _ in self.device
                   if cat == "kernel" and self.stage(name) == stage)

    def host_at(self, t: float, cats=HOST_CATS) -> str | None:
        """The innermost host event of ``cats`` running at time t."""
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0:  # the latest event begun by t, then its ancestors
            _, t1, name, cat = self.host[i]
            if t1 >= t and cat in cats:
                return name
            i = self._parent[i]
        return None

    def gaps(self) -> list[tuple[float, float]]:
        """The idle stretches of the window between device activities."""
        out, last = [], self.start
        for a, b in self.merged():
            if a > last:
                out.append((last, a))
            last = max(last, b)
        if self.end > last:
            out.append((last, self.end))
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, named by the host
        operation that launched them, and the idle seconds by what the host
        was doing in the middle of each gap; TOP entries each."""
        ops: collections.Counter = collections.Counter()
        for t0, t1, cat, name, launch in self.device:
            base = kernel_base(name) if cat == "kernel" else cat
            host = None if launch is None else self.host_at(launch,
                                                            ("cpu_op",))
            label = base if self.stage(name) or host is None \
                else f"{host} > {base}"
            ops[label[:120]] += t1 - t0
        idle: collections.Counter = collections.Counter()
        for a, b in self.gaps():
            idle[(self.host_at((a + b) / 2) or "no host event")[:120]] \
                += b - a
        return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(TOP)]}


def read_chrome_trace(path: str) -> list[dict]:
    """The complete ("X") events of a Chrome trace; none from an empty
    file (a profile that exported nothing)."""
    with open(path) as f:
        text = f.read()
    if not text.strip():
        return []
    data = json.loads(text)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def profile(call, calls: int, frames_per_call: int, stages: dict,
            host_ops: bool = False) -> Trace:
    """Trace ``calls`` calls of ``call`` (each then waited for on the
    device at the end of the stretch).  Without ``host_ops`` the profiler
    records CUDA activity and the runtime calls alone, which costs the host
    little; with them it records every PyTorch operation too, which names
    what the host was doing but slows a launch-bound stretch (PERF.md)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host_ops else [])
    # a first, discarded step lets the profiler's own set-up pass; the
    # active step's trace is exported when it ends
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1)
    for attempt in range(ATTEMPTS):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            with torch.profiler.profile(
                    activities=activities, schedule=schedule,
                    on_trace_ready=lambda p: p.export_chrome_trace(path)
            ) as prof:
                call()
                torch.cuda.synchronize()
                prof.step()
                with record_function(WINDOW_SPAN):
                    for _ in range(calls):
                        with record_function(CALL_SPAN):
                            call()
                    with record_function(SYNC_SPAN):
                        torch.cuda.synchronize()
                prof.step()
            events = read_chrome_trace(path)
        finally:
            os.unlink(path)
        if any(e.get("cat") == "kernel" for e in events):
            return Trace(events, calls * frames_per_call, stages)
        print(f"# profile {attempt + 1} of {ATTEMPTS} recorded no device "
              f"kernel ({len(events)} events)", file=sys.stderr, flush=True)
    raise NoDeviceActivity(f"{ATTEMPTS} profiles recorded no device kernel")
