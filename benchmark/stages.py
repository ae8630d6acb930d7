"""Device work and idle time by the program's stage spans.

While torch.profiler records, fsgm_tpu_torch records a span for each stage
of its entry points (fsgm_tpu_torch/utils/tracing.py: name, parent, start
and end in Unix ns).  ``of(run)`` lays the records over the traced run's
lean profile (``run.trace``), converted to the trace's clock by the
program's ``tracing.trace_us``, keeping those that overlap its window:

  * each device activity (kernel, copy, memset) goes to the innermost span
    open at its launch's runtime call;
  * each idle gap of the window goes to the innermost span open at the
    gap's middle (the rule of Trace.breakdown for host operations).

It gives None, so that the metrics read nothing rather than something
wrong, where the program keeps no records (a program without the spans)
or where fewer than INSIDE_MIN of the window's device activities were
launched inside an entry span (the records do not line up with the
trace).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

ENTRY = ("fsgm.stereo", "fsgm.flow")
# spans that hold stages without being one: device work whose innermost
# span is one of these (or none) lies outside every stage
CONTAINERS = ENTRY + ("fsgm.level", "fsgm.reagg")
INSIDE_MIN = 0.99


@dataclasses.dataclass
class Stages:
    """Seconds and counts by innermost span name (None: no span)."""
    device_s: collections.Counter
    launches: collections.Counter
    idle_s: collections.Counter
    frames: int

    def ms(self, name: str) -> float:
        return self.device_s[name] * 1e3 / self.frames

    def outside_ms(self) -> float:
        return sum(s for k, s in self.device_s.items()
                   if k is None or k in CONTAINERS) * 1e3 / self.frames


def _records():
    try:
        from fsgm_tpu_torch.utils import tracing
    except ImportError:
        return None, None
    return tracing.records(), tracing.trace_us


def innermost(spans):
    """(boundary times, the name open from each) of nested (start, end,
    name) spans: the innermost span open at any time is
    names[bisect_right(times, t) - 1] (None before the first)."""
    times, names, stack = [], [], []

    def close():
        t1, _ = stack.pop()
        times.append(t1)
        names.append(stack[-1][1] if stack else None)
    for t0, t1, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= t0:
            close()
        times.append(t0)
        names.append(name)
        stack.append((t1, name))
    while stack:
        close()
    return times, names


def _at(line, t: float):
    i = bisect.bisect_right(line[0], t) - 1
    return line[1][i] if i >= 0 else None


def of(run) -> Stages | None:
    """The stage breakdown of the run's traced stretch (module
    docstring), or None."""
    trace = run.trace
    recs, trace_us = _records()
    if not recs or not trace.device:
        return None
    spans = []
    for r in recs:
        t0, t1 = trace_us(r.start_ns) * 1e-6, trace_us(r.end_ns) * 1e-6
        if t1 > trace.start and t0 < trace.end:
            spans.append((t0, t1, r.name))
    line = innermost(spans)
    entries = innermost([s for s in spans if s[2] in ENTRY])
    device_s, launches = collections.Counter(), collections.Counter()
    inside = 0
    for t0, t1, _, _, launch in trace.device:
        if launch is None:
            owner = None
        else:
            owner = _at(line, launch)
            inside += _at(entries, launch) is not None
        device_s[owner] += t1 - t0
        launches[owner] += 1
    if inside < INSIDE_MIN * len(trace.device):
        return None
    idle_s = collections.Counter()
    for a, b in trace.gaps():
        idle_s[_at(line, (a + b) / 2)] += b - a
    return Stages(device_s, launches, idle_s, trace.frames)
