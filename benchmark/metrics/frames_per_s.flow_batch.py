"""frames_per_s.flow_batch (end to end, host clock): frames_per_s's
reading (frames whose call completed in the window over the window's
seconds) in the batched flow cells.  Their rate is paced by the host's
launch path and moves with its stalls, so it has a bound of its own,
apart from the device-bound stereo cell's frames_per_s."""

from benchmark import spec


def read(run):
    return spec.load_metric("frames_per_s").read(run)
