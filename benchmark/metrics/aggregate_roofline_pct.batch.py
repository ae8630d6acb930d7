"""aggregate_roofline_pct.batch (ops.kernels, device trace): the least
time of the traced frames' aggregation (benchmark/work/<kind>.py: the
larger of its bytes at the card's peak bandwidth and its operations at
its peak rate, benchmark/work/peaks.json) over the device time of the
kernels that kernels/*.json assign to the "aggregate" stage, in %.
Nothing to read on an unlisted card or where no such kernel ran."""

from benchmark import spec


def read(run):
    spent = run.trace.kernel_s("aggregate")
    if run.peaks is None or spent <= 0:
        return None
    moved, ops = spec.load_work(run.cfg["kind"]).aggregate_work(run.cfg)
    least = max(moved / run.peaks["bytes_per_s"],
                ops / run.peaks["ops_per_s"]) * run.trace.frames
    return 100.0 * least / spent
