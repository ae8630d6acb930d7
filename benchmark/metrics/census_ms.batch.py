"""census_ms.batch (ops, device trace): device ms a frame of the
activities (kernels, copies, memsets) launched inside the program's
fsgm.census spans (benchmark/stages.py)."""

from benchmark import stages


def read(run):
    found = stages.of(run)
    return None if found is None else found.ms("fsgm.census")
