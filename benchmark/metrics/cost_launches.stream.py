"""cost_launches.stream (models, device trace): device activities a frame
launched inside the program's fsgm.cost spans (benchmark/stages.py)."""

from benchmark import stages


def read(run):
    found = stages.of(run)
    return (None if found is None
            else found.launches["fsgm.cost"] / found.frames)
