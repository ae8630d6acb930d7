"""Stage spans and the per-stage kernel-launch count of the port.

    with tracing.span("fsgm.census"):
        ...

marks a stage of an entry point (the names: SPANS).  A span records its
name, its parent span, its start and end in Unix nanoseconds
(``time.time_ns()``, the clock of torch.profiler's Chrome trace:
``trace_us``), its attributes (``frames`` on the entry spans, ``level``
and ``slices`` on level spans, ``dirs`` and ``family`` on aggregation
groups) and the hand-written kernel launches made inside it and not inside
a child span.  While torch.profiler records, a span also enters
``torch.profiler.record_function(name)``, so every Chrome trace of the
program (``utils/profiling.py``, ``bench.py --trace``, the benchmark's
profiles) shows the stages on the device's timeline.

Spans record only while torch.profiler records (torch.autograd.profiler's
enabled flag) or inside ``recording()``, for tests and for stage host
times without the profiler.  Otherwise a span costs one flag test: no
record, no clock read, no record_function.

Records are held in memory, at most CAP of them: past that the oldest go
and ``dropped()`` counts them.  ``take()`` returns the records and clears
them; ``stage_table`` sums them by stage.

``launched(kernel)`` is each kernel wrapper's launch count: it adds one
to ``ops/kernels/_build.LAUNCHES[kernel]`` and, while a span is open, to
that span's ``launches``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time

from torch.autograd import profiler as _profiler

from fsgm_tpu_torch.ops.kernels import _build

# span name -> what it covers
SPANS = {
    "fsgm.stereo": "a stereo_sgm(_batch) call (frames = B)",
    "fsgm.flow": "a flow_fsgm(_batch) call (frames = B)",
    "fsgm.census": "census_transform",
    "fsgm.pyramid": "build_pyramid, the prior's down-sampling, the flow's "
                    "up-sampling between levels",
    "fsgm.level": "one pyramid level (level, slices)",
    "fsgm.cost": "the cost build: K1 in stereo, the flow cost volume",
    "fsgm.transpose": "K5 label_minor_from_major",
    "fsgm.aggregate": "aggregate_paths(_plain)",
    "fsgm.aggregate.group": "one launch_plan group (dirs, family)",
    "fsgm.extract": "K3 / K4 or their plain versions",
    "fsgm.tail": "the float tail: subpixel, LR, median, fill; flow's "
                 "parabola and base + offset",
    "fsgm.median": "median_filter_3x3",
    "fsgm.fb_check": "the forward-backward check and its resampling",
    "fsgm.reagg": "right_disparity_reagg",
}
OUTSIDE = "(outside spans)"  # stage_table's row of device work outside them
CAP = 1 << 16  # records held; a flow call makes about 60
# torch.profiler's Chrome trace gives times in us from a base that is Unix
# time rounded down to a multiple of this period (Kineto's)
TRACE_BASE_PERIOD_S = 7_889_238


@dataclasses.dataclass(eq=False)
class Record:
    """One span: ids number the spans in the order they opened."""
    id: int
    name: str
    parent: int | None
    start_ns: int
    end_ns: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)
    launches: int = 0


_records: collections.deque = collections.deque(maxlen=CAP)
_open: list[Record] = []
_state = {"forced": 0, "next_id": 0, "dropped": 0}


class _Span:
    __slots__ = ("record", "annotation")

    def __init__(self, name: str, attrs: dict):
        parent = _open[-1].id if _open else None
        self.record = Record(_state["next_id"], name, parent, 0, attrs=attrs)
        _state["next_id"] += 1
        self.annotation = None

    def __enter__(self):
        self.record.start_ns = time.time_ns()
        if _profiler._is_profiler_enabled:
            self.annotation = _profiler.record_function(self.record.name)
            self.annotation.__enter__()
        _open.append(self.record)
        return self.record

    def __exit__(self, *exc):
        rec = _open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        rec.end_ns = time.time_ns()
        if len(_records) == CAP:
            _state["dropped"] += 1
        _records.append(rec)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager that records the stage ``name`` (module
    docstring); a shared no-op one while nothing records."""
    if not (_state["forced"] or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs)


def launched(kernel: str) -> None:
    """Count one launch of a hand-written kernel (module docstring)."""
    _build.LAUNCHES[kernel] += 1
    if _open:
        _open[-1].launches += 1


@contextlib.contextmanager
def recording():
    """Record spans inside the block whether or not the profiler runs."""
    _state["forced"] += 1
    try:
        yield
    finally:
        _state["forced"] -= 1


def take() -> list[Record]:
    """The records held (in the order their spans closed), cleared."""
    out = list(_records)
    _records.clear()
    return out


def records() -> list[Record]:
    """The records held, left in place."""
    return list(_records)


def dropped() -> int:
    """Records lost to CAP since the process started."""
    return _state["dropped"]


def trace_base_ns(t_ns: int) -> int:
    """The base of a torch.profiler Chrome trace taken around Unix time
    t_ns (its ``baseTimeNanoseconds``, which readers of the events alone
    do not see)."""
    period = TRACE_BASE_PERIOD_S * 1_000_000_000
    return t_ns // period * period


def trace_us(t_ns: int, base_ns: int | None = None) -> float:
    """A record's time on the Chrome trace's clock: the ``ts`` (us) an
    event at Unix time t_ns carries, from the trace's base (default
    trace_base_ns(t_ns))."""
    return (t_ns - (trace_base_ns(t_ns) if base_ns is None
                    else base_ns)) / 1e3


def _innermost(recs, base_ns: int | None):
    """(boundary times on the trace's clock, the record open from each):
    the innermost of nested records at time t is owners[bisect_right(
    times, t) - 1] (None before the first)."""
    times: list[float] = []
    owners: list[Record | None] = []
    stack: list[tuple[float, Record]] = []

    def close():
        t1, _ = stack.pop()
        times.append(t1)
        owners.append(stack[-1][1] if stack else None)
    for rec in sorted(recs, key=lambda r: (r.start_ns, -r.end_ns)):
        t0 = trace_us(rec.start_ns, base_ns)
        while stack and stack[-1][0] <= t0:
            close()
        times.append(t0)
        owners.append(rec)
        stack.append((trace_us(rec.end_ns, base_ns), rec))
    while stack:
        close()
    return times, owners


def stage_table(recs, frames: int = 1, device=(), base_ns=None
                ) -> list[dict]:
    """Rows by span name, in the order the stages first opened: calls,
    hand-written launches and host self ms (the span's time less its
    children's) a frame, and where ``device`` lists (launch time us on the
    trace's clock, device us) of each device activity, the device ms a
    frame launched inside the span and not inside a child."""
    recs = sorted(recs, key=lambda r: r.start_ns)
    child_ns: collections.Counter = collections.Counter()
    for rec in recs:
        if rec.parent is not None:
            child_ns[rec.parent] += rec.end_ns - rec.start_ns
    rows: dict[str, dict] = {}
    for rec in recs:
        row = rows.setdefault(rec.name, {"stage": rec.name, "calls": 0,
                                         "launches": 0, "host_ms": 0.0})
        row["calls"] += 1
        row["launches"] += rec.launches
        row["host_ms"] += (rec.end_ns - rec.start_ns - child_ns[rec.id]) / 1e6
    if device:
        times, owners = _innermost(recs, base_ns)
        for row in rows.values():
            row["device_ms"] = 0.0
        for launch_us, dur_us in device:
            i = bisect.bisect_right(times, launch_us) - 1
            owner = owners[i] if i >= 0 else None
            name = OUTSIDE if owner is None else owner.name
            rows.setdefault(name, {"stage": name, "calls": 0, "launches": 0,
                                   "host_ms": 0.0, "device_ms": 0.0})
            rows[name]["device_ms"] += dur_us / 1e3
    for row in rows.values():
        for key in ("calls", "launches", "host_ms", "device_ms"):
            if key in row:
                row[key] /= frames
    return list(rows.values())


def format_table(rows: list[dict]) -> list[str]:
    """stage_table's rows as text lines."""
    out = [f"{'stage':22s} {'calls':>8s} {'launches':>9s} {'host ms':>9s}"
           + (f" {'device ms':>10s}" if rows and "device_ms" in rows[0]
              else "") + "  (a frame)"]
    for r in rows:
        out.append(f"{r['stage']:22s} {r['calls']:8.2f} {r['launches']:9.2f}"
                   f" {r['host_ms']:9.4f}"
                   + (f" {r['device_ms']:10.4f}" if "device_ms" in r
                      else ""))
    return out
