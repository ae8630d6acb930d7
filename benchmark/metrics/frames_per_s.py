"""frames_per_s (end to end, host clock): frames whose call completed in
the window over the window's seconds; the window ends at the first
completion at or after --seconds, so it holds whole calls and all their
time."""


def read(run):
    return run.frames_done / run.window_s
