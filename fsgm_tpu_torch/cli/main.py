"""Command-line interface of the PyTorch port.

    python -m fsgm_tpu_torch.cli stereo L.png R.png -o d.png \\
        --preset configs/kitti_stereo.json [--lr-mode reagg] [--fill-invalid]
    python -m fsgm_tpu_torch.cli flow A.png B.png -o f.png \\
        --preset configs/kitti_flow.json
    python -m fsgm_tpu_torch.cli video frames.txt -o outdir --format flo \\
        --preset configs/kitti_flow.json [--track-levels 2]
    python -m fsgm_tpu_torch.cli batch pairs.txt --manifest run.jsonl \\
        --preset configs/kitti_stereo.json --dispatch-batch 16 [--fault-inject N]
    python -m fsgm_tpu_torch.cli serve --preset configs/kitti_stereo.json \\
        [--pipeline K] < requests.jsonl
    python -m fsgm_tpu_torch.cli demo
    python -m fsgm_tpu_torch.cli eval stereo|flow pred.png gt.png
    python -m fsgm_tpu_torch.cli kitti stereo|flow ROOT --year 2015 \\
        [--preset configs/kitti_stereo.json] [--output-dir pred]
    python -m fsgm_tpu_torch.cli bench --config kitti [--stages] [--guard]
    python -m fsgm_tpu_torch.cli scale-test --task stereo|flow --procs 2

Counterpart of fsgm_tpu/cli/main.py ``stereo``, ``flow``, ``video``,
``batch``, ``serve``, ``demo``, ``eval``, ``kitti``, ``bench`` and
``scale-test`` (without ``--model``, the TPU interconnect projection); each
prints the same JSON records (``bench``: fsgm_tpu_torch/bench.py, in this
process).  With
``--preset``, the preset's parameters are taken as they are, as in the
reference.  ``--device`` defaults to ``cuda`` and fails when no card is
present; ``--device cpu`` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from fsgm_tpu_torch import io
from fsgm_tpu_torch.params import FlowParams, SGMParams, load_preset


def _params_from_args(args, cls, required: bool = True):
    """The preset's cls parameters, or, without a preset (or, unless
    required, with a preset that holds no cls), the parameter flags over
    cls's defaults."""
    if getattr(args, "preset", None):
        for v in load_preset(args.preset).values():
            if isinstance(v, cls):
                return v
        if required:
            raise SystemExit(f"preset {args.preset} has no {cls.__name__}")
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in vars(args).items()
          if k in fields and v is not None}
    if "census_window" in kw:
        kw["census_window"] = tuple(kw["census_window"])
    return cls(**kw)


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu for the plain versions)")
    return torch.device(name)


def _gray(path, dev: torch.device) -> torch.Tensor:
    return torch.tensor(io.load_gray(path), device=dev)


def _stack(images, dev: torch.device, task: str) -> torch.Tensor:
    shapes = sorted({a.shape for a in images})
    if len(shapes) != 1:
        raise ValueError(f"{task} needs same-shape pairs, got {shapes}")
    return torch.tensor(np.stack(images), device=dev)


def _density(disp: np.ndarray) -> float:
    return round(float((disp >= 0).mean()), 4)


def _write_flow(out: Path, flow: np.ndarray, valid: np.ndarray) -> float:
    """Write flow (0 where invalid) as .flo or a KITTI PNG; the valid share."""
    masked = np.where(valid[..., None], flow, 0)
    if out.suffix == ".flo":
        io.write_flo(out, masked)
    else:
        io.write_flow_png(out, masked, valid)
    return round(float(valid.mean()), 4)


def _add_stereo_args(sp) -> None:
    sp.add_argument("--preset", help="configs/*.json preset file")
    sp.add_argument("--max-disp", dest="max_disp", type=int)
    sp.add_argument("--p1", type=int)
    sp.add_argument("--p2", type=int)
    sp.add_argument("--num-paths", dest="num_paths", type=int)
    sp.add_argument("--census-window", dest="census_window", type=int,
                    nargs=2)
    sp.add_argument("--adaptive-p2", dest="adaptive_p2",
                    action="store_true", default=None)
    sp.add_argument("--no-subpixel", dest="subpixel", action="store_false",
                    default=None)
    sp.add_argument("--no-lr-check", dest="lr_check", action="store_false",
                    default=None)
    sp.add_argument("--lr-mode", dest="lr_mode",
                    choices=["s_trick", "reagg"],
                    help="right view for the LR check: the S-volume trick "
                    "or a full right-reference re-aggregation")
    sp.add_argument("--no-median", dest="median_filter",
                    action="store_false", default=None)
    sp.add_argument("--fill-invalid", dest="fill_invalid",
                    action="store_true", default=None,
                    help="fill LR-failed pixels from the nearer-background "
                    "valid row neighbour")
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def cmd_stereo(args) -> int:
    from fsgm_tpu_torch.models.stereo import stereo_sgm

    dev = _device(args.device)
    p = _params_from_args(args, SGMParams)
    img_l, img_r = io.load_gray(args.left), io.load_gray(args.right)
    t0 = time.perf_counter()
    disp = stereo_sgm(torch.tensor(img_l, device=dev),
                      torch.tensor(img_r, device=dev), p).cpu().numpy()
    dt = time.perf_counter() - t0
    out = Path(args.output)
    if out.suffix == ".pfm":
        io.write_pfm(out, disp)
    else:
        io.write_disparity_png(out, disp)
    rec = {"cmd": "stereo", "left": str(args.left), "out": str(out),
           "h": img_l.shape[0], "w": img_l.shape[1], "d": p.max_disp,
           "wall_s": round(dt, 4), "valid_frac": _density(disp)}
    print(json.dumps(rec))
    return 0


def densify_flow(flow: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Fill FB-invalidated pixels row-wise from the nearest valid left
    neighbour (else the nearest right one); rows with no valid pixel keep
    their values.  Host-side post-processing for writing dense maps."""
    h, w = valid.shape
    xs = np.arange(w, dtype=np.int64)[None, :]
    left = np.maximum.accumulate(np.where(valid, xs, -1), axis=1)
    right = np.minimum.accumulate(
        np.where(valid, xs, 1 << 30)[:, ::-1], axis=1)[:, ::-1]
    src = np.where(left >= 0, left, right)
    filled = flow[np.arange(h)[:, None], np.clip(src, 0, w - 1)]
    any_valid = valid.any(axis=1, keepdims=True)
    return np.where((valid | ~any_valid)[..., None], flow, filled)


def cmd_flow(args) -> int:
    from fsgm_tpu_torch.models.flow import flow_fsgm

    dev = _device(args.device)
    p = _params_from_args(args, FlowParams)
    img1, img2 = io.load_gray(args.first), io.load_gray(args.second)
    t0 = time.perf_counter()
    flow, valid = flow_fsgm(torch.tensor(img1, device=dev),
                            torch.tensor(img2, device=dev), p)
    flow, valid = flow.cpu().numpy(), valid.cpu().numpy()
    dt = time.perf_counter() - t0
    out = Path(args.output)
    if args.fill_invalid:
        wr, wr_valid = densify_flow(flow, valid), np.ones_like(valid)
    else:
        wr, wr_valid = np.where(valid[..., None], flow, 0), valid
    if out.suffix == ".flo":
        io.write_flo(out, wr)
    else:
        io.write_flow_png(out, wr, wr_valid)
    print(json.dumps({"cmd": "flow", "out": str(out),
                      "wall_s": round(dt, 4),
                      "valid_frac": round(float(valid.mean()), 4)}))
    return 0


def cmd_video(args) -> int:
    """fSGM over a frame sequence with temporal priors: pair 0 runs the
    full pyramid, later pairs seed their coarsest level with the previous
    pair's field (models/flow.py::flow_sequence), through a pyramid of
    --track-levels levels where given."""
    from fsgm_tpu_torch.models.flow import flow_sequence

    dev = _device(args.device)
    p = _params_from_args(args, FlowParams)
    tp = (dataclasses.replace(p, levels=args.track_levels)
          if args.track_levels else None)
    frame_paths = [ln.strip() for ln in
                   Path(args.list).read_text().splitlines() if ln.strip()]
    if len(frame_paths) < 2:
        print("need at least 2 frames", file=sys.stderr)
        return 2
    frames = _stack([io.load_gray(f) for f in frame_paths], dev, "video")
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    flows, valids = flow_sequence(frames, p, track_params=tp)
    flows, valids = flows.cpu().numpy(), valids.cpu().numpy()
    dt = time.perf_counter() - t0
    for t in range(flows.shape[0]):
        name = Path(frame_paths[t]).stem
        if args.fill_invalid:
            fl = densify_flow(flows[t], valids[t])
            wr_valid = np.ones_like(valids[t])
        else:
            fl = np.where(valids[t][..., None], flows[t], 0)
            wr_valid = valids[t]
        if args.format == "flo":
            io.write_flo(outdir / f"{name}.flo", fl)
        else:
            io.write_flow_png(outdir / f"{name}.png", fl, wr_valid)
        print(json.dumps({"cmd": "video", "pair": t,
                          "out": str(outdir / name),
                          "valid_frac": round(float(valids[t].mean()), 4)}))
    print(json.dumps({"cmd": "video", "pairs": int(flows.shape[0]),
                      "wall_s": round(dt, 4),
                      "ms_per_pair": round(1e3 * dt / flows.shape[0], 2)}))
    return 0


def _read_pairs(path) -> list[tuple[str, str, str]]:
    """Lines 'left right out', tab-separated when a tab is present (paths
    with spaces), else whitespace-separated; blank lines skipped."""
    pairs = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        fields = line.split("\t") if "\t" in line else line.split()
        if len(fields) != 3:
            raise SystemExit(
                f"batch list line needs 3 fields (left right out, "
                f"tab-separated if paths contain spaces): {line!r}")
        pairs.append(tuple(f.strip() for f in fields))
    return pairs


def cmd_batch(args) -> int:
    """Stereo over many pairs with a resume manifest and fault injection.

    The workload is stateless per frame, so recovery is re-queueing: the
    manifest makes a rerun skip the frames already written.  Up to
    --dispatch-batch consecutive same-shape pairs run as one
    stereo_sgm_batch pass (one launch per kernel stage for the group); a
    pair of another shape closes the group and opens the next one.
    --fault-inject N exits with code 17 after N frames, as a worker that
    dies would."""
    from fsgm_tpu_torch.models.stereo import stereo_sgm_batch
    from fsgm_tpu_torch.utils.manifest import RunManifest

    dev = _device(args.device)
    p = _params_from_args(args, SGMParams)
    pairs = _read_pairs(args.list)
    manifest = RunManifest(args.manifest)
    todo = manifest.pending([out for _, _, out in pairs])
    queue = [pr for pr in pairs if pr[2] in todo]
    bsz = max(1, args.dispatch_batch)
    done_now, i, carry = 0, 0, None   # carry: a loaded pair of a new shape
    while i < len(queue) or carry is not None:
        group = [carry] if carry is not None else []
        carry = None
        while i < len(queue) and len(group) < bsz:
            left, right, out = queue[i]
            il, ir = io.load_gray(left), io.load_gray(right)
            i += 1
            if group and il.shape != group[0][0].shape:
                carry = (il, ir, out)
                break
            group.append((il, ir, out))
        t0 = time.perf_counter()
        disps = stereo_sgm_batch(
            _stack([g[0] for g in group], dev, "batch"),
            _stack([g[1] for g in group], dev, "batch"), p).cpu().numpy()
        per_frame = round((time.perf_counter() - t0) / len(group), 4)
        for (_, _, out), disp in zip(group, disps):
            io.write_disparity_png(out, disp)
            manifest.mark_done(out, out, wall_s=per_frame,
                               valid_frac=_density(disp))
            done_now += 1
            if args.fault_inject and done_now >= args.fault_inject:
                print(json.dumps({"cmd": "batch", "fault_injected": True,
                                  "done": done_now}), flush=True)
                os._exit(17)
    print(json.dumps({"cmd": "batch", "total": len(pairs),
                      "newly_done": done_now,
                      "skipped": len(pairs) - len(todo)}))
    return 0


def _serve_params(args):
    """serve needs both parameter kinds; a preset usually holds one, and the
    other comes from the flags and the defaults.  A preset holding neither
    is an error."""
    if args.preset and not any(
            isinstance(v, (SGMParams, FlowParams))
            for v in load_preset(args.preset).values()):
        raise SystemExit(f"preset {args.preset} holds neither SGMParams nor "
                         f"FlowParams")
    return (_params_from_args(args, SGMParams, required=False),
            _params_from_args(args, FlowParams, required=False))


def cmd_serve(args) -> int:
    """Persistent serving loop: JSONL requests on stdin, JSONL responses on
    stdout, the kernels built once and kept loaded across requests.

    Request:  {"task": "stereo", "id": any, "left", "right", "out"}
              {"task": "flow", "id": any, "first", "second", "out"}
              {"task": "stereo_batch" | "flow_batch", "id": any,
               "pairs": [[a, b, out], ...]}: same-shape pairs in one
               batched pass
    Response: {"id", "out", "density" | "valid_frac", "wall_s"},
              {"id", "outs", "density" | "valid_frac" (lists), "wall_s"},
              or {"id", "out", "error", "wall_s"} (out None where the
              request named none).
    A blank line or EOF ends the loop.  Responses come in request order.

    --pipeline K: single-pair requests enqueue their device work and park;
    a request is "in flight" until its result tensor is copied to the host,
    which happens once K newer requests are in flight, so reading and
    writing files on the host overlaps the device's work.  wall_s then
    counts from the request's arrival to its response."""
    from fsgm_tpu_torch.models.flow import flow_fsgm, flow_fsgm_batch
    from fsgm_tpu_torch.models.stereo import stereo_sgm, stereo_sgm_batch

    dev = _device(args.device)
    sp, fp = _serve_params(args)
    pipeline = max(0, args.pipeline)
    print(json.dumps({"serving": True, "device": str(dev)}), flush=True)
    served = 0
    pending = deque()  # (id, out, t0, finish) with finish() -> response

    def emit(resp: dict) -> None:
        nonlocal served
        print(json.dumps(resp), flush=True)
        served += 1

    def failed(rid, out, t0, e: Exception) -> dict:
        return {"id": rid, "out": None if out is None else str(out),
                "error": f"{type(e).__name__}: {e}",
                "wall_s": round(time.perf_counter() - t0, 4)}

    def drain(keep: int) -> None:
        while len(pending) > keep:
            rid, out, t0, finish = pending.popleft()
            try:
                resp = finish()
                resp["wall_s"] = round(time.perf_counter() - t0, 4)
            except Exception as e:  # per-request fault isolation
                resp = failed(rid, out, t0, e)
            emit(resp)

    def start_single(req: dict, rid, out: Path):
        """Enqueue one pair's device work; the finish() that fetches and
        writes its result."""
        if req["task"] == "stereo":
            disp_dev = stereo_sgm(_gray(req["left"], dev),
                                  _gray(req["right"], dev), sp)

            def finish():
                disp = disp_dev.cpu().numpy()
                io.write_disparity_png(out, disp)
                return {"id": rid, "out": str(out),
                        "density": _density(disp)}
            return finish
        flow_dev, valid_dev = flow_fsgm(_gray(req["first"], dev),
                                        _gray(req["second"], dev), fp)

        def finish():
            vf = _write_flow(out, flow_dev.cpu().numpy(),
                             valid_dev.cpu().numpy())
            return {"id": rid, "out": str(out), "valid_frac": vf}
        return finish

    def run_batch(req: dict, rid) -> dict:
        pairs = [(io.load_gray(a), io.load_gray(b), Path(o))
                 for a, b, o in req["pairs"]]
        task = req["task"]
        first = _stack([q[0] for q in pairs], dev, task)
        second = _stack([q[1] for q in pairs], dev, task)
        outs = [str(q[2]) for q in pairs]
        if task == "stereo_batch":
            disps = stereo_sgm_batch(first, second, sp).cpu().numpy()
            dens = []
            for (_, _, o), disp in zip(pairs, disps):
                io.write_disparity_png(o, disp)
                dens.append(_density(disp))
            return {"id": rid, "outs": outs, "density": dens}
        flows, valids = flow_fsgm_batch(first, second, fp)
        vfs = [_write_flow(o, fl, va) for (_, _, o), fl, va in
               zip(pairs, flows.cpu().numpy(), valids.cpu().numpy())]
        return {"id": rid, "outs": outs, "valid_frac": vfs}

    for line in sys.stdin:
        line = line.strip()
        if not line:
            break
        t0 = time.perf_counter()
        rid, out = served + len(pending), None
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("a request is one JSON object")
            rid = req.get("id", rid)
            out = Path(req["out"]) if "out" in req else None
            task = req.get("task")
            if task in ("stereo", "flow"):
                if out is None:
                    raise KeyError("out")
                finish = start_single(req, rid, out)
                pending.append((rid, out, t0, finish))
                drain(pipeline)
                continue
            if task not in ("stereo_batch", "flow_batch"):
                raise ValueError(f"unknown task {task!r}")
            drain(0)
            resp = run_batch(req, rid)
            resp["wall_s"] = round(time.perf_counter() - t0, 4)
        except Exception as e:  # per-request fault isolation
            drain(0)
            resp = failed(rid, out, t0, e)
        emit(resp)
    drain(0)
    print(json.dumps({"served": served}), flush=True)
    return 0


def cmd_eval(args) -> int:
    from fsgm_tpu_torch.eval import d1_all, fl_all

    if args.task == "stereo":
        pred = io.read_disparity_png(args.pred)
        gt = io.read_disparity_png(args.gt)
        m = d1_all(pred, gt, gt > 0)
    else:
        pred, pred_valid = io.read_flow_png(args.pred)
        gt, valid = io.read_flow_png(args.gt)
        m = fl_all(pred, gt, valid, pred_valid=pred_valid)
    print(json.dumps(m))
    return 0


def cmd_demo(args) -> int:
    """Synthetic end-to-end run: stereo and flow on generated pairs with
    known ground truth."""
    from fsgm_tpu_torch.eval import d1_all, fl_all
    from fsgm_tpu_torch.models.flow import flow_fsgm
    from fsgm_tpu_torch.models.stereo import stereo_sgm

    dev = _device(args.device)
    img_l, img_r, gt = io.random_dot_stereo(128, 160, 32, seed=1)
    disp = stereo_sgm(torch.tensor(img_l, device=dev),
                      torch.tensor(img_r, device=dev),
                      SGMParams(max_disp=32)).cpu().numpy()
    print(json.dumps({"demo": "stereo",
                      **d1_all(disp, gt.astype(np.float64), gt > 0)}))
    i1, i2, fgt = io.constant_flow_pair(96, 128, 3, -2, seed=2)
    flow, fvalid = flow_fsgm(torch.tensor(i1, device=dev),
                             torch.tensor(i2, device=dev),
                             FlowParams(search_radius=4, levels=3))
    print(json.dumps({"demo": "flow",
                      **fl_all(flow.cpu().numpy(), fgt,
                               pred_valid=fvalid.cpu().numpy())}))
    return 0


def cmd_kitti(args) -> int:
    """A KITTI 2012/2015 devkit tree: one JSON record per frame (wall_s,
    and D1-all / Fl-all where the split has ground truth), then the
    summary; --output-dir writes the predictions in devkit naming.  Flow
    runs FlowParams() unless --preset gives other parameters."""
    from fsgm_tpu_torch.eval import d1_all, fl_all
    from fsgm_tpu_torch.io.datasets import (KittiFlowDataset,
                                            KittiStereoDataset)

    dev = _device(args.device)
    outdir = Path(args.output_dir) if args.output_dir else None
    if outdir:
        outdir.mkdir(parents=True, exist_ok=True)
    records = []
    if args.task == "stereo":
        from fsgm_tpu_torch.models.stereo import stereo_sgm
        ds = KittiStereoDataset(args.root, year=args.year, split=args.split,
                                occ=not args.noc)
        p = _params_from_args(args, SGMParams)
        for smp in ds:
            t0 = time.perf_counter()
            disp = stereo_sgm(torch.tensor(smp.left, device=dev),
                              torch.tensor(smp.right, device=dev),
                              p).cpu().numpy()
            rec = {"frame": smp.name,
                   "wall_s": round(time.perf_counter() - t0, 4)}
            if smp.gt is not None:
                rec.update(d1_all(disp, smp.gt.astype(np.float64),
                                  smp.gt_valid))
            if outdir:
                io.write_disparity_png(outdir / f"{smp.name}_10.png", disp)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        err_key = "d1_all"
    else:
        from fsgm_tpu_torch.models.flow import flow_fsgm
        ds = KittiFlowDataset(args.root, year=args.year, split=args.split,
                              occ=not args.noc)
        p = _params_from_args(args, FlowParams) if args.preset \
            else FlowParams()
        for smp in ds:
            t0 = time.perf_counter()
            flow, valid = flow_fsgm(torch.tensor(smp.img1, device=dev),
                                    torch.tensor(smp.img2, device=dev), p)
            flow, valid = flow.cpu().numpy(), valid.cpu().numpy()
            rec = {"frame": smp.name,
                   "wall_s": round(time.perf_counter() - t0, 4)}
            if smp.gt is not None:
                rec.update(fl_all(flow, smp.gt, smp.gt_valid,
                                  pred_valid=valid))
            if outdir:
                io.write_flow_png(outdir / f"{smp.name}_10.png",
                                  np.where(valid[..., None], flow, 0),
                                  valid)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        err_key = "fl_all"
    scored = [r for r in records if err_key in r]
    summary = {"cmd": "kitti", "task": args.task, "year": args.year,
               "frames": len(records), "scored": len(scored)}
    if scored:
        summary[err_key] = round(
            float(np.mean([r[err_key] for r in scored])), 4)
        summary["mean_wall_s"] = round(
            float(np.mean([r["wall_s"] for r in records])), 4)
    print(json.dumps(summary))
    return 0


SCALE_TIMEOUT_S = 600.0  # each launch of the scale-test ranks


def scale_job(task: str, ranks: int, devices_per_proc: int, reps: int,
              device: str, tmp: Path) -> dict:
    """The scale-test job on ``ranks`` ranks (parallel/ranks.py): one frame
    a rank over devices_per_proc row tiles, at fsgm_tpu/cli/main.py's
    scale-test shapes: stereo 96x128, D=32, fast with margin 8; flow
    96x128, radius 3, 3 levels, exact."""
    from fsgm_tpu_torch.params import DistParams
    from fsgm_tpu_torch.parallel.ranks import run_spec
    if task == "stereo":
        params = SGMParams(max_disp=32, p1=7, p2=60)
        dist = DistParams(tiles_y=devices_per_proc, frame_shards=ranks,
                          tile_mode="fast", margin=8)
        pairs = [io.random_dot_stereo(96, 128, 32, seed=s)
                 for s in range(ranks)]
    else:
        params = FlowParams(search_radius=3, levels=3, p1=7, p2=60)
        dist = DistParams(tiles_y=devices_per_proc, frame_shards=ranks,
                          tile_mode="exact")
        pairs = [io.constant_flow_pair(96, 128, 2, -1, seed=s)
                 for s in range(ranks)]
    a, b = (np.stack(x) for x in zip(*[q[:2] for q in pairs]))
    return {"device": device, "timeout_s": SCALE_TIMEOUT_S, "runs": [
        run_spec(task, params, dist, a, b, tmp / f"{task}_{ranks}.npz",
                 reps=reps, devices_per_proc=devices_per_proc)]}


def cmd_scale_test(args) -> int:
    """Weak scaling over local ranks: the tiled pipeline on 1 and then
    --procs ranks of a gloo group, one frame a rank over --devices-per-proc
    row tiles; frames/s of --reps timed calls after one, and the
    efficiency against the one-rank rate.  Ranks that share one card give
    no weak-scaling figure: they divide the card between them."""
    from fsgm_tpu_torch.parallel import ranks
    from fsgm_tpu_torch.parallel.multihost import weak_scaling_report
    dev = _device(args.device)
    if args.procs < 1 or args.reps < 1:
        raise SystemExit("--procs and --reps must be at least 1")
    if dev.type == "cuda":
        from fsgm_tpu_torch.ops.kernels import _build
        _build.build_all()  # once, before any rank starts
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        for n in sorted({1, args.procs}):
            job = scale_job(args.task, n, args.devices_per_proc, args.reps,
                            args.device, Path(tmp))
            try:
                reports = ranks.launch(job, n, args.port)
            except RuntimeError as e:
                print(f"scale-test on {n} ranks: {e}", file=sys.stderr)
                return 1
            rates[n] = reports[0]["runs"][0]["frames_per_s"]
    rep = weak_scaling_report(rates[args.procs], args.procs, rates[1])
    rep["frames_per_s_1host"] = rates[1]
    rep["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    print(json.dumps(rep))
    return 0


def cmd_bench(args) -> int:
    from fsgm_tpu_torch import bench
    return bench.run_args(args)


def build_parser() -> argparse.ArgumentParser:
    from fsgm_tpu_torch import bench
    ap = argparse.ArgumentParser(prog="fsgm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("stereo", help="disparity for a rectified pair")
    sp.add_argument("left")
    sp.add_argument("right")
    sp.add_argument("-o", "--output", required=True)
    _add_stereo_args(sp)
    sp.set_defaults(fn=cmd_stereo)

    fp = sub.add_parser("flow", help="fSGM optical flow for an image pair")
    fp.add_argument("first")
    fp.add_argument("second")
    fp.add_argument("-o", "--output", required=True)
    fp.add_argument("--preset", help="configs/*.json preset file")
    fp.add_argument("--search-radius", dest="search_radius", type=int)
    fp.add_argument("--levels", type=int)
    fp.add_argument("--p1", type=int)
    fp.add_argument("--p2", type=int)
    fp.add_argument("--fill-invalid", dest="fill_invalid",
                    action="store_true",
                    help="densify: fill FB-invalidated pixels from the "
                    "nearest valid row neighbour")
    fp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    fp.set_defaults(fn=cmd_flow)

    vp = sub.add_parser("video",
                        help="fSGM over a frame sequence (temporal prior)")
    vp.add_argument("list", help="file of frame paths, one per line")
    vp.add_argument("-o", "--outdir", required=True)
    vp.add_argument("--format", default="png", choices=["png", "flo"])
    vp.add_argument("--preset", help="configs/*.json preset file")
    vp.add_argument("--search-radius", dest="search_radius", type=int)
    vp.add_argument("--levels", type=int)
    vp.add_argument("--track-levels", dest="track_levels", type=int,
                    default=0, help="pyramid depth of the tracked pairs "
                    "(0 = that of pair 0)")
    vp.add_argument("--p1", type=int)
    vp.add_argument("--p2", type=int)
    vp.add_argument("--fill-invalid", dest="fill_invalid",
                    action="store_true",
                    help="densify: fill FB-invalidated pixels from the "
                    "nearest valid row neighbour")
    vp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    vp.set_defaults(fn=cmd_video)

    bp = sub.add_parser("batch", help="batch stereo with a resume manifest")
    bp.add_argument("list", help="file of lines: left right out.png")
    bp.add_argument("--manifest", required=True)
    bp.add_argument("--fault-inject", dest="fault_inject", type=int,
                    default=0, help="exit with code 17 after N frames "
                    "(recovery test)")
    bp.add_argument("--dispatch-batch", dest="dispatch_batch", type=int,
                    default=1, help="same-shape pairs per stereo_sgm_batch "
                    "pass")
    _add_stereo_args(bp)
    bp.set_defaults(fn=cmd_batch)

    svp = sub.add_parser("serve", help="persistent JSONL request loop on "
                         "stdin")
    svp.add_argument("--preset", help="configs/*.json preset file")
    svp.add_argument("--max-disp", dest="max_disp", type=int)
    svp.add_argument("--search-radius", dest="search_radius", type=int)
    svp.add_argument("--levels", type=int)
    svp.add_argument("--p1", type=int)
    svp.add_argument("--p2", type=int)
    svp.add_argument("--pipeline", type=int, default=0, metavar="K",
                     help="keep up to K single-pair requests in flight "
                     "before fetching results (responses stay in request "
                     "order; 0 = fetch per request)")
    svp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    svp.set_defaults(fn=cmd_serve)

    dp = sub.add_parser("demo", help="synthetic end-to-end smoke run")
    dp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dp.set_defaults(fn=cmd_demo)

    ep = sub.add_parser("eval", help="D1-all / Fl-all against ground truth")
    ep.add_argument("task", choices=["stereo", "flow"])
    ep.add_argument("pred")
    ep.add_argument("gt")
    ep.set_defaults(fn=cmd_eval)

    kp = sub.add_parser("kitti",
                        help="run a KITTI 2012/2015 devkit directory")
    kp.add_argument("task", choices=["stereo", "flow"])
    kp.add_argument("root", help="dataset root (holds training/testing)")
    kp.add_argument("--year", type=int, default=2015, choices=[2012, 2015])
    kp.add_argument("--split", default="training")
    kp.add_argument("--noc", action="store_true",
                    help="score against the noc (non-occluded) ground "
                    "truth, not occ")
    kp.add_argument("--output-dir", dest="output_dir",
                    help="write predictions here (devkit naming)")
    _add_stereo_args(kp)
    kp.set_defaults(fn=cmd_kitti)

    st = sub.add_parser("scale-test",
                        help="weak-scaling harness over N local ranks")
    st.add_argument("--task", default="stereo", choices=["stereo", "flow"])
    st.add_argument("--procs", type=int, default=2)
    st.add_argument("--devices-per-proc", dest="devices_per_proc", type=int,
                    default=4, help="row tiles a rank (on its card)")
    st.add_argument("--reps", type=int, default=3)
    st.add_argument("--port", type=int, default=0,
                    help="rendezvous port on 127.0.0.1 (0 = a free one)")
    st.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    st.set_defaults(fn=cmd_scale_test)

    bnp = sub.add_parser("bench", help="throughput harness "
                         "(fsgm_tpu_torch/bench.py)")
    bench.add_arguments(bnp)
    bnp.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
