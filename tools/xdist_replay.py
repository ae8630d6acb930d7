"""Replay pytest-xdist's `--dist loadfile` schedule from measured test times.

    python -m pytest tests/ ... -n 6 --dist loadfile --junitxml=run.xml
    python -m pytest tests/ -m 'not slow' --collect-only -q | grep :: > ids.txt
    python tools/xdist_replay.py run.xml ids.txt [--workers 6] [--files]

The Tier-1 suite's wall time is set by its longest worker, and with
`--dist loadfile` that depends on the order in which files are handed out:
xdist queues the files by test count, most first (ties in collection
order), gives each worker one file, and hands a worker the next file as
soon as it has two tests of its own left.  This script runs that rule
over the per-test times of a JUnit XML report and the node ids of a
collection (one per line, in collection order), so that a test layout can
be judged before a 25-minute run.  A node id missing from the report (a
test moved to another file) takes the time of the reported test of the
same name; an unknown test takes 0.5 s.  Prints the replayed wall time
and, with --files, each file's start and end.
"""

from __future__ import annotations

import argparse
import collections
import xml.etree.ElementTree as ET

START_S = 20.0        # workers start after collection
UNKNOWN_S = 0.5


def load_times(xml_path: str) -> dict[str, float]:
    """node id -> seconds, from a pytest JUnit XML report."""
    out = {}
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        path = case.get("classname").replace(".", "/") + ".py"
        out[f"{path}::{case.get('name')}"] = float(case.get("time"))
    return out


def load_order(ids_path: str) -> dict[str, list[str]]:
    """file -> its node ids, files in collection order."""
    order: dict[str, list[str]] = {}
    with open(ids_path) as f:
        for line in f:
            nid = line.strip()
            if "::" in nid:
                order.setdefault(nid.split("::")[0], []).append(nid)
    return order


def seconds_per_test(order: dict[str, list[str]],
                     times: dict[str, float]) -> dict[str, float]:
    by_name = {}
    for nid, t in times.items():
        by_name.setdefault(nid.split("::", 1)[1], t)
    return {nid: times.get(nid, by_name.get(nid.split("::", 1)[1],
                                            UNKNOWN_S))
            for ids in order.values() for nid in ids}


def replay(order: dict[str, list[str]], seconds: dict[str, float],
           workers: int):
    """(wall seconds, {file: start}, {file: end}) under xdist's rule."""
    queue = collections.deque(sorted(order.items(),
                                     key=lambda kv: -len(kv[1])))
    pending = [collections.deque() for _ in range(workers)]
    clock = [START_S] * workers
    start, end = {}, {}

    def assign(w):
        f, ids = queue.popleft()
        pending[w].extend((f, seconds[nid]) for nid in ids)

    for w in range(workers):
        if queue:
            assign(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            assign(w)
    while any(pending):
        w = min((i for i in range(workers) if pending[i]),
                key=lambda i: clock[i])
        f, t = pending[w].popleft()
        start.setdefault(f, clock[w])
        clock[w] += t
        end[f] = clock[w]
        if queue and len(pending[w]) <= 2:
            assign(w)
    return max(clock), start, end


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit_xml")
    ap.add_argument("node_ids")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--files", action="store_true",
                    help="print each file's start and end")
    args = ap.parse_args(argv)
    order = load_order(args.node_ids)
    seconds = seconds_per_test(order, load_times(args.junit_xml))
    wall, start, end = replay(order, seconds, args.workers)
    if args.files:
        for f in sorted(start, key=start.get):
            print(f"{start[f]:8.1f} {end[f]:8.1f} {len(order[f]):4d} {f}")
    print(f"replayed wall time: {wall:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
