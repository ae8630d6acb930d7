"""Ranks as local processes: start a job on N ranks of a gloo group on this
host, wait for them, and read what each reports.

    python -m fsgm_tpu_torch.parallel.ranks JOB --rank R --world N \\
        --coordinator 127.0.0.1:PORT

is one rank (``worker``); ``launch(job, n)`` starts n of them and returns
their reports.  A job (JSON) holds ``device`` ("cuda" or "cpu"),
``timeout_s`` and a list of ``runs``, each made by ``run_spec``; a run
names a ``task`` ("stereo"
or "flow"), its ``params`` and ``dist`` (params.params_to_json's dicts),
``devices_per_proc`` (parallel/multihost.py's global_mesh, one frame shard
a rank), an ``inputs`` .npz file holding the whole (F, H, W) batch as
"a" and "b", ``reps`` timed calls after the first, and an optional
``out`` .npz file, which rank 0 writes ("out", and "valid" for flow).
Every rank receives the whole batch and runs stereo_sgm_sharded /
flow_fsgm_sharded with its RankMesh, so every rank returns the whole
result.  Each rank prints one JSON line last: its rank, world and device,
the modules of jax, fsgm_tpu and golden it loaded (none), and per run the
first call's wall time and kernel launches (ops/kernels/_build.LAUNCHES,
cleared just before and read just after), its peak device memory, the
mean time of the timed calls and a digest of the gathered result.

A rank that fails makes ``launch`` kill the others and raise with its
error; so does a job that outlives its timeout.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

FOREIGN = ("jax", "fsgm_tpu", "golden")
REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def foreign_modules() -> list[str]:
    """Loaded modules of jax, the JAX package or golden/."""
    return sorted(m for m in sys.modules if m in FOREIGN
                  or m.startswith(tuple(r + "." for r in FOREIGN)))


def run_spec(task: str, params, dist, a, b, inputs, out=None,
             reps: int = 0, devices_per_proc: int = 1) -> dict:
    """One run of a job: writes the whole (F, H, W) batch ``a``, ``b``
    (tensors or arrays) to the .npz file ``inputs`` and returns the run
    that reads it (see the module docstring); rank 0 writes the result to
    ``out`` when it is given."""
    from fsgm_tpu_torch.params import params_to_json
    np.savez(inputs, **{k: torch.as_tensor(x).cpu().numpy()
                        for k, x in (("a", a), ("b", b))})
    spec = {"task": task, "params": json.loads(params_to_json(params)),
            "dist": json.loads(params_to_json(dist)),
            "devices_per_proc": devices_per_proc, "inputs": str(inputs),
            "reps": reps}
    if out is not None:
        spec["out"] = str(out)
    return spec


def launch(job: dict, world: int, port: int = 0) -> list[dict]:
    """Run ``job`` on ``world`` local ranks (rendezvous on 127.0.0.1:port,
    0 = a free port); each rank's report, by rank.  CPU ranks share this
    process's intra-op threads.  Raises RuntimeError when a rank fails or
    the job outlives job["timeout_s"], after killing every rank still
    running."""
    port = port or free_port()
    threads = max(1, torch.get_num_threads() // world)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [str(REPO), env.get("PYTHONPATH")]))
    spec = json.dumps(job)
    with tempfile.TemporaryDirectory() as tmp:
        logs = [(open(Path(tmp) / f"{r}.out", "w+"),
                 open(Path(tmp) / f"{r}.err", "w+")) for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "fsgm_tpu_torch.parallel.ranks", spec,
             "--rank", str(r), "--world", str(world),
             "--coordinator", f"127.0.0.1:{port}", "--threads", str(threads)],
            env=env, cwd=REPO, stdout=out, stderr=err)
            for r, (out, err) in enumerate(logs)]
        try:
            _wait(procs, [err for _, err in logs], job["timeout_s"])
            return [json.loads(_read(out).strip().splitlines()[-1])
                    for out, _ in logs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for out, err in logs:
                out.close()
                err.close()


def _read(f) -> str:
    f.seek(0)
    return f.read()


def _wait(procs, errs, timeout_s: float) -> None:
    """Until every rank has exited 0; raises on the first rank that exits
    otherwise, with its stderr, and at the deadline."""
    deadline = time.monotonic() + timeout_s
    while True:
        codes = [p.poll() for p in procs]
        for r, code in enumerate(codes):
            if code not in (None, 0):
                raise RuntimeError(f"rank {r} of {len(procs)} exited with "
                                   f"{code}:\n{_read(errs[r])[-4000:]}")
        if all(code == 0 for code in codes):
            return
        if time.monotonic() > deadline:
            raise RuntimeError(f"ranks still running after {timeout_s} s")
        time.sleep(0.05)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(spec: dict, device) -> dict:
    """One run of a job on this rank (see the module docstring)."""
    from fsgm_tpu_torch.ops.kernels import _build
    from fsgm_tpu_torch.params import params_from_json
    from fsgm_tpu_torch.parallel.multihost import global_mesh
    from fsgm_tpu_torch.parallel.tiled import stereo_sgm_sharded
    from fsgm_tpu_torch.parallel.tiled_flow import flow_fsgm_sharded

    mesh = global_mesh(devices_per_proc=spec["devices_per_proc"],
                       device=device)
    dev = mesh.devices[0]
    params = params_from_json(json.dumps(spec["params"]))
    dist = params_from_json(json.dumps(spec["dist"]))
    with np.load(spec["inputs"]) as z:
        a, b = (torch.from_numpy(z[k]).to(dev) for k in ("a", "b"))
    sharded = {"stereo": stereo_sgm_sharded,
               "flow": flow_fsgm_sharded}[spec["task"]]

    def call():
        return sharded(a, b, params, dist, mesh)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = call()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 20
            if dev.type == "cuda" else None)
    per_call = None
    if spec["reps"]:
        t0 = time.perf_counter()
        for _ in range(spec["reps"]):
            call()
        _sync(dev)
        per_call = (time.perf_counter() - t0) / spec["reps"]
    outs = out if isinstance(out, tuple) else (out,)
    digest = hashlib.sha256()
    for y in outs:
        digest.update(y.cpu().numpy().tobytes())
    if spec.get("out") and mesh.rank == 0:
        names = ("out", "valid")[:len(outs)]
        np.savez(spec["out"], **{k: y.cpu().numpy()
                                 for k, y in zip(names, outs)})
    return {"task": spec["task"], "frames": int(a.shape[0]),
            "wall_s": wall, "launches": launches, "peak_mib": peak,
            "s_per_call": per_call,
            "frames_per_s": a.shape[0] / per_call if per_call else None,
            "digest": digest.hexdigest()}


def worker(argv=None) -> int:
    """One rank: join the group, run the job's runs, print the report."""
    from fsgm_tpu_torch.parallel.multihost import init_distributed
    ap = argparse.ArgumentParser(prog="fsgm_tpu_torch.parallel.ranks")
    ap.add_argument("job", help="the job, as JSON")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--threads", type=int, default=1,
                    help="intra-op threads of a CPU rank")
    args = ap.parse_args(argv)
    job = json.loads(args.job)
    device = "cpu" if job["device"] == "cpu" else None
    if device == "cpu":
        torch.set_num_threads(args.threads)
    init_distributed(args.coordinator, args.world, args.rank,
                     timeout_s=job["timeout_s"])
    try:
        runs = [run(spec, device) for spec in job["runs"]]
    finally:
        torch.distributed.destroy_process_group()
    name = (torch.cuda.get_device_name(args.rank % torch.cuda.device_count())
            if job["device"] == "cuda" else "cpu")
    print(json.dumps({"rank": args.rank, "world": args.world,
                      "device": name, "foreign": foreign_modules(),
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(worker())
