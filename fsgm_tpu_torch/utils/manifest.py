"""Checkpoint / resume for batch runs: the port's own copy of
fsgm_tpu/utils/manifest.py.

The workload is stateless per frame, so recovery is re-queueing the
unfinished frames: a JSONL manifest records each finished frame's id and
output path, and a re-run skips the frames it lists whose output exists.
"""

from __future__ import annotations

import json
import os
from pathlib import Path


class RunManifest:
    """Append-only JSONL manifest; safe across crashes (one fsync'd line per
    finished frame; a torn last line is ignored and its frame re-runs)."""

    def __init__(self, path):
        self.path = Path(path)
        self._done: dict[str, dict] = {}
        if self.path.exists():
            for line in self.path.read_text().splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn write from a crash: the frame re-runs
                if rec.get("status") == "done":
                    self._done[rec["frame_id"]] = rec

    def is_done(self, frame_id: str) -> bool:
        rec = self._done.get(frame_id)
        if rec is None:
            return False
        out = rec.get("output")
        return out is None or Path(out).exists()

    def mark_done(self, frame_id: str, output: str | None = None,
                  **extra) -> None:
        rec = {"frame_id": frame_id, "status": "done", "output": output,
               **extra}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._done[frame_id] = rec

    def pending(self, frame_ids) -> list:
        return [f for f in frame_ids if not self.is_done(f)]
