"""Execution across processes: the frame axis over torch.distributed ranks.

Counterpart of fsgm_tpu/parallel/multihost.py.  The JAX package builds a
("frame", "ty") mesh whose frame axis spans processes and hands it to the
tiled entry points; here ``global_mesh`` gives each rank a ``RankMesh``
(its rank, the world, the mesh's sizes and its local devices), which
parallel/tiled.py::stereo_sgm_sharded and
parallel/tiled_flow.py::flow_fsgm_sharded take in ``devices``.  Every rank
receives the whole (F, H, W) batch, runs its own frame shards on its local
devices (the row tiles' exchanges stay inside the rank) and all-gathers the
finished frames, so every rank returns the whole result.

The process group is gloo and the gather is staged through the host: NCCL
refuses two ranks on one card, and gloo's all_gather takes CPU tensors
only.  Frame parallelism exchanges the finished frames once a call, so the
host staging costs little beside the frames' own work.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Callable

import torch
import torch.distributed as dist

from fsgm_tpu_torch.params import DistParams


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     timeout_s: float = 300.0) -> None:
    """Join the gloo process group: ``coordinator`` "host:port" (rank 0
    serves the rendezvous there) with ``num_processes`` ranks, this one
    ``process_id``; with no coordinator, the ``env://`` variables that
    ``torchrun`` sets.  A rank that does not arrive, or a collective that
    waits longer than ``timeout_s``, raises instead of hanging."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator is None:
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """One rank's view of the ("frame", "ty") mesh: ``frame`` frame shards
    over ``world`` ranks (frame / world on each), ``ty`` tiles a shard, and
    the rank's (frame / world) * ty local devices in (frame, ty) order."""

    rank: int
    world: int
    frame: int
    ty: int
    devices: tuple

    @property
    def frame_per_process(self) -> int:
        return self.frame // self.world


def _rank_and_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(frame_per_process: int = 1, devices_per_proc: int = 1,
                device=None) -> RankMesh:
    """This rank's RankMesh: frame = world * frame_per_process shards, ty =
    devices_per_proc // frame_per_process tiles a shard.  Local device i of
    rank r is cuda:{(r * devices_per_proc + i) % device_count}, so with one
    device a rank it is cuda:{r % device_count}, and ranks share a card
    where there are fewer cards than ranks; ``device`` puts every local
    device on that one (``"cpu"`` for the plain versions).  Outside a
    process group the mesh is rank 0 of 1."""
    if frame_per_process < 1 or devices_per_proc < 1 \
            or devices_per_proc % frame_per_process:
        raise ValueError(f"devices_per_proc {devices_per_proc} must be a "
                         f"positive multiple of frame_per_process "
                         f"{frame_per_process}")
    rank, world = _rank_and_world()
    if device is not None:
        devs = (torch.device(device),) * devices_per_proc
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("global_mesh: no CUDA device is available "
                               "(pass device='cpu' for the plain versions)")
        n = torch.cuda.device_count()
        devs = tuple(torch.device("cuda", (rank * devices_per_proc + i) % n)
                     for i in range(devices_per_proc))
    return RankMesh(rank, world, world * frame_per_process,
                    devices_per_proc // frame_per_process, devs)


def run_rank_shards(mesh: RankMesh, dist_params: DistParams, fn: Callable,
                    *imgs: torch.Tensor):
    """Run this rank's frame shards and gather every rank's frames.

    imgs: the whole (F, H, W, ...) batch, the same on every rank.  fn(local
    images, the local DistParams (frame_per_process shards), the local
    devices) returns one tensor or a tuple of tensors over the local frames;
    each is all-gathered along the frame axis and returned on the images'
    device (bool tensors travel as uint8)."""
    if dist_params.frame_shards != mesh.frame:
        raise ValueError(f"frame_shards {dist_params.frame_shards} must "
                         f"equal the mesh's frame axis {mesh.frame}")
    f = imgs[0].shape[0]
    if f % mesh.frame:
        raise ValueError(f"{f} frames must divide by the mesh's frame axis "
                         f"{mesh.frame}")
    fl = f // mesh.world
    frames = slice(mesh.rank * fl, (mesh.rank + 1) * fl)
    local = dataclasses.replace(dist_params,
                                frame_shards=mesh.frame_per_process)
    out = fn(*(x[frames] for x in imgs), local, list(mesh.devices))
    gathered = tuple(gather_frames(mesh, y, imgs[0].device)
                     for y in (out if isinstance(out, tuple) else (out,)))
    return gathered if isinstance(out, tuple) else gathered[0]


def gather_frames(mesh: RankMesh, x: torch.Tensor,
                  device: torch.device) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated along dim 0 in rank
    order, on ``device``: gloo's all_gather over host copies."""
    if mesh.world == 1:
        return x.to(device)
    host = x.to("cpu", torch.uint8 if x.dtype == torch.bool else x.dtype)
    parts = [torch.empty_like(host) for _ in range(mesh.world)]
    dist.all_gather(parts, host.contiguous())
    return torch.cat(parts).to(device, x.dtype)


def weak_scaling_report(frames_per_s: float, n_hosts: int,
                        baseline_1host: float) -> dict:
    """Frames/s at n_hosts against n_hosts x the one-host rate."""
    eff = frames_per_s / (baseline_1host * n_hosts) if baseline_1host else 0.0
    return {"hosts": n_hosts, "frames_per_s": frames_per_s,
            "weak_scaling_efficiency": round(eff, 4)}
