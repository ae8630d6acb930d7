"""median_ms.batch (ops, device trace): device ms a frame of the
activities launched inside the program's fsgm.median spans
(benchmark/stages.py)."""

from benchmark import stages


def read(run):
    found = stages.of(run)
    return None if found is None else found.ms("fsgm.median")
