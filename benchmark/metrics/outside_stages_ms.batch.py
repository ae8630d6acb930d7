"""outside_stages_ms.batch (models, device trace): device ms a frame of the
activities launched outside every stage span (inside only an entry, level
or reagg span, or none): what the spans miss (benchmark/stages.py)."""

from benchmark import stages


def read(run):
    found = stages.of(run)
    return None if found is None else found.outside_ms()
