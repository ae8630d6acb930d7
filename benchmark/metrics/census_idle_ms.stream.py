"""census_idle_ms.stream (device, device trace): idle ms a frame in the
gaps of the profiled window whose middle falls inside the program's
fsgm.census spans: the device waiting on census's host launches
(benchmark/stages.py)."""

from benchmark import stages


def read(run):
    found = stages.of(run)
    return (None if found is None
            else found.idle_s["fsgm.census"] * 1e3 / found.frames)
