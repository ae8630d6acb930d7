"""Structured logging with a per-rank prefix.

Counterpart of fsgm_tpu/utils/logging.py.  Ranks of one run interleave
their output; the prefix ``[host i/N]`` (rank i of a torch.distributed
group of N) makes merged logs attributable.  ``log_record`` writes JSONL
records (one machine-readable line per event) beside human messages.
"""

from __future__ import annotations

import json
import logging
import sys
import time

import torch.distributed as dist


def host_prefix() -> str:
    """``"[host i/N] "`` inside a process group of N > 1 ranks, else ``""``."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world > 1:
            return f"[host {dist.get_rank()}/{world}] "
    return ""


def get_logger(name: str = "fsgm") -> logging.Logger:
    """A stderr logger whose lines carry the rank prefix."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            host_prefix() + "%(asctime)s %(name)s %(levelname)s %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def log_record(stream, **fields) -> None:
    """One JSONL record (per-frame metrics etc.); stream = file object or
    path.  Adds "ts" and, inside a group of several ranks, "host"."""
    fields.setdefault("ts", round(time.time(), 3))
    pid = host_prefix().strip("[] ")
    if pid:
        fields.setdefault("host", pid)
    line = json.dumps(fields, sort_keys=True)
    if hasattr(stream, "write"):
        stream.write(line + "\n")
        stream.flush()
    else:
        with open(stream, "a") as f:
            f.write(line + "\n")
