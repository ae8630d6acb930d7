"""On-card smoke run of the PyTorch port (fsgm_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Three main paths: stereo (configs/kitti_stereo.json, 375x1242, D=128), fSGM
flow (configs/kitti_flow.json, 375x1242, 4 levels, 81 labels) and batched
stereo (stereo_sgm_batch, 16 frames of config 2 in one pass).  Phases, each
of which raises on failure (non-zero exit, no ok line):

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the five kernels from fsgm_tpu_torch/csrc, one nvcc per source,
     all started together;
  2. stereo kernels K1 census_cost, K2 sgm_sweep (1D labels), K3
     extract_stereo against their plain PyTorch versions on the card,
     exact, at the KITTI shape (random-dot pair) and at 37x53, D=32;
  3. flow kernels K5 label_minor_from_major, K2 sgm_sweep (2D labels) and
     K4 extract_flow against their plain versions, exact, on one flow level
     with a non-zero prior: the config-4 level-0 shape (375x1242, 81 labels
     padded to 96, blockwise_flow_pair(375, 1242, 8, seed=0)), and 37x53
     with radius 2 and adaptive P2, and with an int32 S;
  4. stereo_sgm end to end against stereo_sgm_reference (plain versions
     only): identical invalid mask, valid disparities within 1e-3, D1-all
     against the ground truth, and each kernel's launch count in that call;
  5. flow_fsgm end to end against flow_fsgm_reference at config 4:
     identical validity planes, valid flow within 1e-3, Fl-all / EPE /
     valid share against the ground truth, and each kernel's launch count
     in that call; flow_fsgm_batch on 2 frames equals per-frame flow_fsgm;
  6. batched stereo: K1 (left and right reference), K2 (each direction and
     the summed S) and K3 (with and without the right-view pass) over B
     frames against their plain versions, exact, at config 1
     (configs/tsukuba.json, 288x384, D=64) and at config 2, B=16 each (the
     batched path's own shapes), on frames of different content where one
     frame's last row is bright and the next one's first row dark;
     stereo_sgm_batch at config 2
     (the main path, launches counted: one K1, one K2 per direction, one
     K3) and at config 1, B=16 each, and at 4K (configs/tiled_4k.json,
     2160x3840, D=128) with B=2, where the batch's int16 S passes 4 GiB,
     equal to per-frame stereo_sgm bit for bit; stereo_sgm with lr_mode="reagg" and with fill_invalid at config 2
     against stereo_sgm_reference; the `batch` CLI (a --fault-inject run,
     exit 17, then the resume) and a `serve` stereo_batch request on the
     card, on PNGs written to a temporary directory;
  7. CUDA-event timings (median after warm-up) of each kernel and its plain
     version on the main paths' inputs (K2: the frame's 8 launches over
     prebuilt P2' tables; the flow kernels at level 0; K1, K2 and K3 also
     over the 16 frames of the batched path), K5 beside PyTorch's own axis
     exchange (library_ms), the device launches of the plain-torch flow
     cost build and census, the pipelines end to end, and the batched
     path's ms and launches per frame at B=1 and B=16.

Each kernel's bound_ms is the larger of two times for this run's shapes:
the bytes it must move (each input read once, each output written once;
label pad slots that no kernel reads are not counted) over 3.35 TB/s, and
its integer operations over 67e12 op/s (the H100's float32 rate outside the
tensor cores; the table of peaks has no int32 rate, so this bound is
generous).  The batched rows count the same per frame, times B.
Operations per element: K1 3 (xor, popcount, select) per cost
byte; K2 8 per label and direction for 1D labels (two shuffled neighbours,
+P1, three mins, +C-m, the warp min), 11 for 2D labels (two more neighbour
mins); K3 6 per S value (two packed keys, two mins); K4 3 per S value
(shift, or, min); K5 none.

The run fails if anything in it loaded a module of jax, fsgm_tpu or golden.
The last lines are the per-kernel JSON record, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

KITTI = (375, 1242, 128)
TSUKUBA = (288, 384, 64)
UHD = (2160, 3840, 128)   # configs/tiled_4k.json: S of 2 frames > 4 GiB
SMALL = (37, 53, 32)
BATCH = 16        # frames per stereo_sgm_batch call on the batched path
CLI_FRAMES = 4    # KITTI-size pairs through the batch CLI
REPO = Path(__file__).resolve().parent
FLOW_HW = (375, 1242)
FLOW_SMALL = (37, 53)
FLOW_MAX_MAG = 8
SEED = 0
DISP_TOL = 1e-3  # f32 subpixel: both sides use the same IEEE formula
FLOW_TOL = 1e-3  # the float tail is the same torch code on both sides
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# name: (csrc source, TPU kernel it replaces, the others, main paths); the
# kernels line's `launches` is the first path's count, launches_by_path all
SOURCES = {
    "census_cost": ("cost", "fsgm_tpu/ops/pallas/cost_tr.py:106",
                    ["fsgm_tpu/ops/pallas/cost_tr.py:264",
                     "fsgm_tpu/ops/pallas/cost_tr.py:158"],
                    ("stereo", "stereo_batch")),
    "sgm_sweep": ("sgm_sweep", "fsgm_tpu/ops/pallas/aggregate_tr.py:289",
                  None, ("stereo", "flow", "stereo_batch")),
    "extract_stereo": ("extract", "fsgm_tpu/ops/pallas/extract_tr.py:227",
                       None, ("stereo", "stereo_batch")),
    "extract_flow": ("extract_flow", "fsgm_tpu/ops/pallas/extract_tr.py:387",
                     None, ("flow",)),
    "label_minor_from_major": (
        "transpose", "fsgm_tpu/ops/pallas/transpose_pallas.py:83", None,
        ("flow",)),
}
FOREIGN = ("jax", "fsgm_tpu", "golden")


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def foreign_modules() -> list[str]:
    """Loaded modules of jax, the JAX package or golden/."""
    return sorted(m for m in sys.modules if m in FOREIGN
                  or m.startswith(tuple(r + "." for r in FOREIGN)))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_launches(fn) -> int:
    """Device kernels, memsets and copies of one fn() call (torch.profiler,
    after one warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for the given work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> int:
    """Largest |a - b|, frame by frame over a leading batch axis (the int64
    copies of a 16-frame KITTI volume would take 23 GB at once)."""
    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    pairs = zip(a, b) if a.dim() == 4 else [(a, b)]
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               for x, y in pairs)


def pair(h, w, d, seed, dev):
    from fsgm_tpu_torch.io import random_dot_stereo
    il, ir, gt = random_dot_stereo(h, w, d, seed=seed)
    return (torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev), gt)


def frame_stack(h, w, d, b, seed, dev, bleed: bool = False):
    """(B, H, W) left and right stacks of random-dot pairs (seeds seed ..
    seed + B - 1); with bleed, frame 0's last row bright and frame 1's
    first row dark in both views."""
    from fsgm_tpu_torch.io import random_dot_stereo
    pairs = [random_dot_stereo(h, w, d, seed=seed + k) for k in range(b)]
    il = np.stack([p[0] for p in pairs])
    ir = np.stack([p[1] for p in pairs])
    if bleed:
        il[0, -1], ir[0, -1] = 255, 255
        if b > 1:
            il[1, 0], ir[1, 0] = 0, 0
    return torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev)


def flow_pair(h, w, seed, dev):
    from fsgm_tpu_torch.io import blockwise_flow_pair
    i1, i2, gt, gt_valid = blockwise_flow_pair(h, w, FLOW_MAX_MAG, seed=seed)
    return (torch.from_numpy(i1).to(dev), torch.from_numpy(i2).to(dev), gt,
            gt_valid)


def check_kernels(shape, params, dev, dirs, tag: str) -> dict:
    """Each stereo kernel against its plain version on one input; returns
    the largest absolute error per kernel (all must be 0)."""
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.ops.kernels import cost, extract

    h, w, d = shape
    tl, tr, _ = pair(h, w, d, SEED, dev)
    cl = census_transform(tl, params.census_window)
    cr = census_transform(tr, params.census_window)
    c = cost.census_cost(cl, cr, d, params.invalid_cost)
    errs = {"census_cost": max_err(c, cost.census_cost_plain(
        cl, cr, d, params.invalid_cost))}
    require(errs["census_cost"] == 0, f"{tag} census_cost != plain")

    s_dtype = agg.plan_dtypes(params.s_invalid)
    sweep_err = 0
    for r in dirs:
        p2e = agg.p2_effective(tl, r, params.p1, params.p2,
                               params.adaptive_p2)
        got = agg.sgm_sweep(c, p2e, r, params.p1, s_dtype=s_dtype)
        want = agg.sgm_sweep_plain(c, p2e, r, params.p1)
        e = max_err(got, want)
        print(f"{tag} sgm_sweep direction {r}: max_abs_err {e}")
        require(e == 0, f"{tag} sgm_sweep {r} != plain")
        sweep_err = max(sweep_err, e)
    s = agg.aggregate_paths(c, tl, dirs, params.p1, params.p2,
                            params.adaptive_p2, params.s_invalid)
    s_ref = agg.aggregate_paths_plain(c, tl, dirs, params.p1, params.p2,
                                      params.adaptive_p2, params.s_invalid)
    e = max_err(s, s_ref)
    require(s.dtype == s_ref.dtype and e == 0, f"{tag} S != plain")
    errs["sgm_sweep"] = max(sweep_err, e)

    got = extract.extract_stereo(s, params.s_invalid, params.lr_max_diff,
                                 params.subpixel)
    want = extract.extract_stereo_plain(s, params.s_invalid,
                                        params.lr_max_diff, params.subpixel)
    names = ("d_int", "s_m", "s_0", "s_p", "valid")
    es = {n: max_err(a, b) for n, a, b in zip(names, got, want)}
    print(f"{tag} extract_stereo max_abs_err {es}")
    require(all(v == 0 for v in es.values()), f"{tag} extract != plain")
    errs["extract_stereo"] = max(es.values())
    print(f"{tag} kernels == plain: {errs}")
    return errs


def check_extract_ties(dev) -> None:
    """K3 on an int32 volume full of ties and of values at s_invalid."""
    from fsgm_tpu_torch.ops.kernels import extract
    g = torch.Generator(device="cpu").manual_seed(SEED)
    s = torch.randint(0, 4, (24, 70, 64), generator=g, dtype=torch.int32)
    s[:, -20:, 40:] = 5000
    s = s.to(dev)
    got = extract.extract_stereo(s, 5000, 1, True)
    want = extract.extract_stereo_plain(s, 5000, 1, True)
    errs = [max_err(a, b) for a, b in zip(got, want)]
    require(all(e == 0 for e in errs), "extract ties != plain")
    print(f"extract ties/int32 volume: max_abs_err {errs}")


def check_batch_kernels(shape, b, params, dev, tag: str) -> dict:
    """K1 (left and right reference), K2 (each direction and the sum) and K3
    (with and without the right-view pass) over B frames against their
    plain versions; returns the largest absolute error per kernel."""
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.ops.kernels import cost, extract

    h, w, d = shape
    tl, tr = frame_stack(h, w, d, b, SEED, dev, bleed=True)
    cl = census_transform(tl, params.census_window)
    cr = census_transform(tr, params.census_window)
    k1 = 0
    for rr in (False, True):
        got = cost.census_cost(cl, cr, d, params.invalid_cost, rr)
        k1 = max(k1, max_err(got, cost.census_cost_plain(
            cl, cr, d, params.invalid_cost, rr)))
        del got
    require(k1 == 0, f"{tag} batched census_cost != plain")
    c = cost.census_cost(cl, cr, d, params.invalid_cost)
    s_dtype = agg.plan_dtypes(params.s_invalid)
    k2 = 0
    for r in params.dirs:
        p2e = agg.p2_effective(tl, r, params.p1, params.p2,
                               params.adaptive_p2)
        got = agg.sgm_sweep(c, p2e, r, params.p1, s_dtype=s_dtype)
        k2 = max(k2, max_err(got, agg.sgm_sweep_plain(c, p2e, r, params.p1)))
        del got
    require(k2 == 0, f"{tag} batched sgm_sweep != plain")
    s = agg.aggregate_paths(c, tl, params.dirs, params.p1, params.p2,
                            params.adaptive_p2, params.s_invalid)
    s_ref = agg.aggregate_paths_plain(c, tl, params.dirs, params.p1,
                                      params.p2, params.adaptive_p2,
                                      params.s_invalid)
    require(s.dtype == s_ref.dtype, f"{tag} batched S dtype")
    k2 = max(k2, max_err(s, s_ref))
    require(k2 == 0, f"{tag} batched S != plain")
    del c, s_ref
    k3 = 0
    for with_rwta in (True, False):
        got = extract.extract_stereo(s, params.s_invalid, params.lr_max_diff,
                                     params.subpixel, with_rwta)
        want = extract.extract_stereo_plain(s, params.s_invalid,
                                            params.lr_max_diff,
                                            params.subpixel, with_rwta)
        require((got[4] is None) == (not with_rwta) == (want[4] is None),
                f"{tag} K3 validity plane with_rwta={with_rwta}")
        k3 = max([k3] + [max_err(a, x) for a, x in zip(got, want)
                         if a is not None])
    require(k3 == 0, f"{tag} batched extract_stereo != plain")
    errs = {"census_cost": k1, "sgm_sweep": k2, "extract_stereo": k3}
    print(f"{tag} batched kernels == plain ({b} frames, S {s.dtype}): "
          f"{errs}")
    return errs


def check_batch_path(shape, b, params, dev, tag: str) -> dict:
    """stereo_sgm_batch on B frames, launches counted in that call only,
    equal to per-frame stereo_sgm bit for bit; the launch counts."""
    from fsgm_tpu_torch import stereo_sgm, stereo_sgm_batch
    from fsgm_tpu_torch.ops.kernels import _build

    h, w, d = shape
    tl, tr = frame_stack(h, w, d, b, SEED, dev)
    _build.LAUNCHES.clear()
    disp = stereo_sgm_batch(tl, tr, params)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"launches in one stereo_sgm_batch call ({tag}, {b} frames): "
          f"{launches}")
    want = {"census_cost": 1, "sgm_sweep": len(params.dirs),
            "extract_stereo": 1}
    require(launches == want, f"{tag} batch launches {launches} != {want}")
    require(tuple(disp.shape) == (b, h, w) and disp.dtype == torch.float32
            and bool(torch.isfinite(disp).all()),
            f"{tag} batch shape / finiteness")
    per = torch.stack([stereo_sgm(tl[k], tr[k], params) for k in range(b)])
    require(torch.equal(disp, per), f"{tag} stereo_sgm_batch != per-frame")
    print(f"{tag}: stereo_sgm_batch ({b} frames) == per-frame stereo_sgm, "
          f"density {float((disp >= 0).float().mean()):.4f}")
    return launches


def check_lr_options(params, dev) -> None:
    """stereo_sgm with lr_mode="reagg" and with fill_invalid at config 2
    against stereo_sgm_reference, with the launches of each call."""
    from fsgm_tpu_torch import stereo_sgm, stereo_sgm_reference
    from fsgm_tpu_torch.eval import d1_all
    from fsgm_tpu_torch.ops.kernels import _build

    h, w, d = KITTI
    tl, tr, gt = pair(h, w, d, SEED, dev)
    for kw in (dict(lr_mode="reagg"), dict(fill_invalid=True)):
        q = dataclasses.replace(params, **kw)
        _build.LAUNCHES.clear()
        disp = stereo_sgm(tl, tr, q)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        ref = stereo_sgm_reference(tl, tr, q)
        require(bool(torch.isfinite(disp).all()), f"{kw} finiteness")
        require(torch.equal(disp < 0, ref < 0), f"{kw} invalid mask != plain")
        both = (disp >= 0) & (ref >= 0)
        err = float((disp[both] - ref[both]).abs().max())
        require(err <= DISP_TOL, f"{kw} disparity error {err}")
        m = d1_all(disp.cpu().numpy(), gt.astype(np.float64))
        print(f"stereo_sgm {kw} vs plain: invalid mask equal, max |disp "
              f"err| {err}; D1-all {m['d1_all']:.4f} density "
              f"{m['density']:.4f}; launches {launches}")


def run_cli(args, stdin: str | None = None, expect: int = 0) -> list[dict]:
    """python -m fsgm_tpu_torch.cli <args> on the card; its JSON lines."""
    proc = subprocess.run([sys.executable, "-m", "fsgm_tpu_torch.cli", *args,
                           "--device", "cuda"], cwd=REPO, input=stdin,
                          capture_output=True, text=True, timeout=600)
    require(proc.returncode == expect,
            f"cli {args[0]} exit {proc.returncode} != {expect}: "
            f"{proc.stderr[-2000:]}")
    return [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]


def check_cli(params, dev) -> None:
    """The batch CLI with a fault injection and the resume, and a serve
    stereo_batch request, on KITTI-size PNG pairs; every written disparity
    equal to stereo_sgm's within the PNG's 1/256 step."""
    from fsgm_tpu_torch import stereo_sgm
    from fsgm_tpu_torch.io import (load_gray, random_dot_stereo,
                                   read_disparity_png, save_gray)

    h, w, d = KITTI
    preset = str(REPO / "configs" / "kitti_stereo.json")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lines = []
        for k in range(CLI_FRAMES):
            il, ir, _ = random_dot_stereo(h, w, d, seed=SEED + 40 + k)
            save_gray(tmp / f"l{k}.png", il)
            save_gray(tmp / f"r{k}.png", ir)
            lines.append([str(tmp / f"l{k}.png"), str(tmp / f"r{k}.png"),
                          str(tmp / f"d{k}.png")])
        lst = tmp / "pairs.txt"
        lst.write_text("\n".join("\t".join(x) for x in lines) + "\n")
        args = ["batch", str(lst), "--manifest", str(tmp / "run.jsonl"),
                "--preset", preset, "--dispatch-batch", "2"]
        out = run_cli(args + ["--fault-inject", "2"], expect=17)
        require(out[-1] == {"cmd": "batch", "fault_injected": True,
                            "done": 2}, f"fault-inject record {out}")
        out = run_cli(args)
        require(out[-1] == {"cmd": "batch", "total": CLI_FRAMES,
                            "newly_done": CLI_FRAMES - 2, "skipped": 2},
                f"resume record {out}")
        reqs = [{"task": "stereo_batch", "id": "sb",
                 "pairs": [[a, b, o.replace(".png", "_s.png")]
                           for a, b, o in lines[:2]]},
                {"task": "stereo", "id": "s", "left": lines[2][0],
                 "right": lines[2][1], "out": str(tmp / "single.png")}]
        out = run_cli(["serve", "--preset", preset, "--pipeline", "1"],
                      stdin="".join(json.dumps(r) + "\n" for r in reqs)
                      + "\n")
        require([r.get("id") for r in out[1:-1]] == ["sb", "s"]
                and all("error" not in r for r in out),
                f"serve responses {out}")
        written = [(x[2], x) for x in lines]
        written += [(x[2].replace(".png", "_s.png"), x) for x in lines[:2]]
        written.append((str(tmp / "single.png"), lines[2]))
        worst = 0.0
        for path, (a, b, _) in written:
            want = stereo_sgm(torch.tensor(load_gray(a), device=dev),
                              torch.tensor(load_gray(b), device=dev),
                              params).cpu().numpy()
            got = read_disparity_png(path)
            require(np.array_equal(got < 0, want < 0), f"{path} mask")
            worst = max(worst, float(np.abs(got - want)[want >= 0].max()))
        require(worst <= 1 / 256, f"CLI disparity error {worst}")
    print(f"cli batch (fault-inject after 2, resume of {CLI_FRAMES - 2}) and "
          f"serve stereo_batch + stereo on {h}x{w} PNGs: {len(written)} "
          f"outputs == stereo_sgm within {worst} (PNG step 1/256)")


def flow_level(hw, params, dev) -> dict:
    """One flow level as the main path builds it, on a blockwise pair with a
    non-zero prior (the ground truth, rounded, plus integer noise in
    [-2, 2] from the seed): census, label-major cost padded to a multiple
    of 32, and the P2' tables of the 8 directions."""
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.cost import cost_volume_flow_major
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.params import DIRS_8

    h, w = hw
    t1, t2, gt, _ = flow_pair(h, w, SEED, dev)
    rng = np.random.default_rng(SEED)
    prior = np.rint(gt) + rng.integers(-2, 3, gt.shape)
    bu, bv = (torch.from_numpy(prior[..., k].astype(np.int32)).to(dev)
              for k in (0, 1))
    require(bool((bu != 0).any() and (bv != 0).any()), "prior is zero")
    nl = params.num_labels
    cen1 = census_transform(t1, params.census_window)
    cen2 = census_transform(t2, params.census_window)
    cost_m = cost_volume_flow_major(cen1, cen2, bu, bv, params.search_radius,
                                    params.invalid_cost,
                                    nl_pad=-(-nl // 32) * 32)
    p2es = [agg.p2_effective(t1, r, params.p1, params.p2, params.adaptive_p2)
            for r in DIRS_8]
    return dict(img=t1, cost_m=cost_m, p2es=p2es, dirs=DIRS_8, nl=nl,
                e=params.window_extent, p1=params.p1,
                s_dtype=agg.plan_dtypes(8 * (params.invalid_cost
                                             + params.p2)))


def flow_sweeps(lv, cost, plain: bool = False):
    """The level's 8 sweeps over prebuilt P2' tables: S."""
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    if plain:
        return sum(agg.sgm_sweep_plain(cost, p2e, r, lv["p1"], lv["e"],
                                       lv["nl"])
                   for r, p2e in zip(lv["dirs"], lv["p2es"])
                   ).to(lv["s_dtype"])
    s = None
    for r, p2e in zip(lv["dirs"], lv["p2es"]):
        s = agg.sgm_sweep(cost, p2e, r, lv["p1"], s=s, s_dtype=lv["s_dtype"],
                          label_ext=lv["e"], nl=lv["nl"])
    return s


def check_flow_kernels(hw, params, dev, tag: str) -> dict:
    """K5, K2 (2D rule, each direction and the sum) and K4 (with and
    without subpixel) against their plain versions on one flow level;
    returns the largest absolute error per kernel (all must be 0)."""
    from fsgm_tpu_torch.ops.kernels import aggregate as agg
    from fsgm_tpu_torch.ops.kernels import extract, transpose

    lv = flow_level(hw, params, dev)
    c = transpose.label_minor_from_major(lv["cost_m"])
    errs = {"label_minor_from_major": max_err(
        c, transpose.label_minor_from_major_plain(lv["cost_m"]))}
    require(errs["label_minor_from_major"] == 0, f"{tag} K5 != plain")
    sweep_err = 0
    for r, p2e in zip(lv["dirs"], lv["p2es"]):
        got = agg.sgm_sweep(c, p2e, r, lv["p1"], s_dtype=lv["s_dtype"],
                            label_ext=lv["e"], nl=lv["nl"])
        want = agg.sgm_sweep_plain(c, p2e, r, lv["p1"], lv["e"], lv["nl"])
        e = max_err(got, want)
        require(e == 0, f"{tag} sgm_sweep 2D {r} != plain")
        sweep_err = max(sweep_err, e)
    s = flow_sweeps(lv, c)
    s_ref = flow_sweeps(lv, c, plain=True)
    e = max_err(s, s_ref)
    require(s.dtype == s_ref.dtype and e == 0, f"{tag} flow S != plain")
    errs["sgm_sweep"] = max(sweep_err, e)
    k4 = 0
    for with_sub in (True, False):
        got = extract.extract_flow(s, lv["nl"], lv["e"], with_sub)
        want = extract.extract_flow_plain(s, lv["nl"], lv["e"], with_sub)
        got = (got[0],) + (got[1] + got[2] if with_sub else ())
        want = (want[0],) + (want[1] + want[2] if with_sub else ())
        k4 = max([k4] + [max_err(a, b) for a, b in zip(got, want)])
    errs["extract_flow"] = k4
    require(k4 == 0, f"{tag} extract_flow != plain")
    print(f"{tag} flow kernels == plain (S {s.dtype}, "
          f"{tuple(c.shape)} label-minor cost): {errs}")
    return errs


def merge_errs(*dicts) -> dict:
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = max(out.get(k, 0), v)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from fsgm_tpu_torch import (DIRS_16, FlowParams, SGMParams, flow_fsgm,
                                flow_fsgm_batch, flow_fsgm_reference,
                                load_preset, stereo_sgm, stereo_sgm_batch,
                                stereo_sgm_reference)
    from fsgm_tpu_torch.eval import d1_all, fl_all
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.cost import cost_volume_flow_major
    from fsgm_tpu_torch.ops.kernels import _build, cost, extract, transpose
    from fsgm_tpu_torch.ops.kernels import aggregate as agg

    # 0. the card
    dev = torch.device("cuda")
    card_line = card()
    kind = torch.cuda.get_device_name(0)
    print(card_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 1. build: one nvcc per source, all started together
    libs = [lib for lib, _, _, _ in SOURCES.values()]
    require(sorted(libs) == sorted(_build.ENTRY), "a kernel is not checked")
    t0 = time.perf_counter()
    _build.build_all()
    for lib in libs:
        _build.load(lib)
    print(f"build {', '.join(f'{lib}.cu' for lib in libs)}: "
          f"{time.perf_counter() - t0:.2f} s")

    # 2. stereo kernels against their plain versions
    params = load_preset("configs/kitti_stereo.json")["sgm"]
    errs = check_kernels(KITTI, params, dev, params.dirs, "kitti")
    small = SGMParams(max_disp=SMALL[2], p1=7, p2=60, adaptive_p2=True,
                      num_paths=16)
    errs = merge_errs(errs, check_kernels(SMALL, small, dev, DIRS_16,
                                          "37x53 16-path adaptive"))
    wide = SGMParams(max_disp=SMALL[2], p2=7000)  # s_invalid >= 2^15: int32 S
    errs = merge_errs(errs, check_kernels(SMALL, wide, dev, wide.dirs,
                                          "37x53 int32 S"))
    check_extract_ties(dev)

    # 3. flow kernels against their plain versions
    fparams = load_preset("configs/kitti_flow.json")["flow"]
    errs = merge_errs(errs, check_flow_kernels(FLOW_HW, fparams, dev,
                                               "config-4 level 0"))
    fsmall = FlowParams(search_radius=2, levels=3, adaptive_p2=True)
    errs = merge_errs(errs, check_flow_kernels(
        FLOW_SMALL, fsmall, dev, "37x53 radius 2 adaptive"))
    fwide = FlowParams(search_radius=2, levels=3, p2=5000)  # int32 S
    errs = merge_errs(errs, check_flow_kernels(FLOW_SMALL, fwide, dev,
                                               "37x53 radius 2 int32 S"))

    # 4. the stereo path end to end, launches counted in this call only
    h, w, d = KITTI
    tl, tr, gt = pair(h, w, d, SEED, dev)
    _build.LAUNCHES.clear()
    disp = stereo_sgm(tl, tr, params)
    torch.cuda.synchronize()
    launches = {"stereo": dict(_build.LAUNCHES)}
    print(f"launches in one stereo_sgm call: {launches['stereo']}")
    ref = stereo_sgm_reference(tl, tr, params)
    require(tuple(disp.shape) == (h, w) and bool(torch.isfinite(disp).all()),
            "disparity shape / finiteness")
    require(torch.equal(disp < 0, ref < 0), "invalid mask != plain")
    both = (disp >= 0) & (ref >= 0)
    derr = float((disp[both] - ref[both]).abs().max())
    require(derr <= DISP_TOL, f"disparity error {derr} > {DISP_TOL}")
    m = d1_all(disp.cpu().numpy(), gt.astype(np.float64))
    print(f"stereo end to end vs plain: invalid mask equal, max |disp err| "
          f"{derr}; D1-all {m['d1_all']:.4f} EPE {m['epe']:.4f} "
          f"density {m['density']:.4f}")

    # 5. the flow path end to end, launches counted in this call only
    fh, fw = FLOW_HW
    f1, f2, fgt, fgt_valid = flow_pair(fh, fw, SEED, dev)
    _build.LAUNCHES.clear()
    flow, valid = flow_fsgm(f1, f2, fparams)
    torch.cuda.synchronize()
    launches["flow"] = dict(_build.LAUNCHES)
    print(f"launches in one flow_fsgm call: {launches['flow']}")
    fref, fref_valid = flow_fsgm_reference(f1, f2, fparams)
    require(tuple(flow.shape) == (fh, fw, 2) and flow.dtype == torch.float32
            and bool(torch.isfinite(flow).all()), "flow shape / finiteness")
    require(torch.equal(valid, fref_valid), "validity plane != plain")
    require(bool(valid.any()), "no flow pixel passed the fb check")
    ferr = float((flow - fref)[valid].abs().max())
    require(ferr <= FLOW_TOL, f"flow error {ferr} > {FLOW_TOL}")
    fm = fl_all(flow.cpu().numpy().astype(np.float64), fgt, fgt_valid,
                pred_valid=valid.cpu().numpy())
    print(f"flow end to end vs plain: validity equal, max |flow err| {ferr} "
          f"on valid pixels; Fl-all {fm['fl_all']:.4f} EPE {fm['epe']:.4f} "
          f"valid share {float(valid.float().mean()):.4f} (density on "
          f"ground-truth-valid pixels {fm['density']:.4f})")
    g1, g2, _, _ = flow_pair(fh, fw, SEED + 1, dev)
    fb, vb = flow_fsgm_batch(torch.stack([f1, g1]), torch.stack([f2, g2]),
                             fparams)
    fo, vo = flow_fsgm(g1, g2, fparams)
    require(torch.equal(fb[0], flow) and torch.equal(vb[0], valid)
            and torch.equal(fb[1], fo) and torch.equal(vb[1], vo),
            "flow_fsgm_batch != per-frame")
    print("flow_fsgm_batch (2 frames) == per-frame flow_fsgm")

    # 6. batched stereo: kernels over B frames, the batched path (config 2,
    #    16 frames, launches counted in this call only), reagg and fill, CLI
    tparams = load_preset("configs/tsukuba.json")["sgm"]
    errs = merge_errs(errs, check_batch_kernels(TSUKUBA, BATCH, tparams, dev,
                                                "config-1"))
    errs = merge_errs(errs, check_batch_kernels(KITTI, BATCH, params, dev,
                                                "config-2"))
    launches["stereo_batch"] = check_batch_path(KITTI, BATCH, params, dev,
                                                "config 2")
    check_batch_path(TSUKUBA, BATCH, tparams, dev, "config 1")
    check_batch_path(UHD, 2, load_preset("configs/tiled_4k.json")["sgm"], dev,
                     "4K")
    check_lr_options(params, dev)
    check_cli(params, dev)
    for name, (_, _, _, paths) in SOURCES.items():
        for path in paths:
            require(launches[path].get(name, 0) > 0,
                    f"{name} not launched on the {path} path")

    # 7. timings, each kernel on its main path's inputs
    cl = census_transform(tl, params.census_window)
    cr = census_transform(tr, params.census_window)
    cost_args = (cl, cr, d, params.invalid_cost)
    c = cost.census_cost(*cost_args)
    s_dtype = agg.plan_dtypes(params.s_invalid)
    p2es = [agg.p2_effective(tl, r, params.p1, params.p2, params.adaptive_p2)
            for r in params.dirs]

    def sweeps():
        s = None
        for r, p2e in zip(params.dirs, p2es):
            s = agg.sgm_sweep(c, p2e, r, params.p1, s=s, s_dtype=s_dtype)
        return s

    def sweeps_plain():
        return sum(agg.sgm_sweep_plain(c, p2e, r, params.p1)
                   for r, p2e in zip(params.dirs, p2es)).to(s_dtype)

    ext_args = (sweeps(), params.s_invalid, params.lr_max_diff,
                params.subpixel)
    lv = flow_level(FLOW_HW, fparams, dev)
    fc = transpose.label_minor_from_major(lv["cost_m"])
    fs = flow_sweeps(lv, fc)
    nl, nd_f = lv["nl"], fc.shape[2]
    hw, s_bytes = h * w, torch.tensor([], dtype=s_dtype).element_size()
    fs_bytes = fs.element_size()
    fhw, n_dirs = fh * fw, len(params.dirs)
    work = {  # name: (kernel, plain, (bytes, ops), shape, library call)
        "census_cost": (
            lambda: cost.census_cost(*cost_args),
            lambda: cost.census_cost_plain(*cost_args),
            (2 * hw * 8 + hw * d, 3 * hw * d), (h, w, d), None),
        "sgm_sweep": (
            sweeps, sweeps_plain,
            (hw * d + n_dirs * hw * 4 + hw * d * s_bytes,
             8 * n_dirs * hw * d), (h, w, d), None),
        "extract_stereo": (
            lambda: extract.extract_stereo(*ext_args),
            lambda: extract.extract_stereo_plain(*ext_args),
            (hw * d * s_bytes + 5 * hw * 4, 6 * hw * d), (h, w, d), None),
        "sgm_sweep_2d": (
            lambda: flow_sweeps(lv, fc),
            lambda: flow_sweeps(lv, fc, plain=True),
            (fhw * nl + 8 * fhw * 4 + fhw * nl * fs_bytes, 11 * 8 * fhw * nl),
            (fh, fw, nd_f), None),
        "extract_flow": (
            lambda: extract.extract_flow(fs, nl, lv["e"], fparams.subpixel),
            lambda: extract.extract_flow_plain(fs, nl, lv["e"],
                                               fparams.subpixel),
            (fhw * nl * fs_bytes + 7 * fhw * 4, 3 * fhw * nl),
            (fh, fw, nd_f), None),
        "label_minor_from_major": (
            lambda: transpose.label_minor_from_major(lv["cost_m"]),
            lambda: transpose.label_minor_from_major_plain(lv["cost_m"]),
            (2 * fhw * nd_f, 0), (fh, fw, nd_f),
            lambda: lv["cost_m"].transpose(1, 2).contiguous()),
    }
    slow_plain = {"sgm_sweep", "sgm_sweep_2d"}  # Python loops: few reps
    times = {}
    for name, (kern, plain, (nbytes, nops), shape, lib) in work.items():
        reps = 3 if name in slow_plain else 10
        plain_ms = median_ms(plain, reps=reps, warmup=1)
        ms = median_ms(kern)
        lib_ms = median_ms(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, nops)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms)
        lib_txt = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms by {b_by} ({nbytes} B, {nops} ops)"
              f"{lib_txt} (shape {shape}; {card_line})")
    e2e = median_ms(lambda: stereo_sgm(tl, tr, params))
    e2e_plain = median_ms(lambda: stereo_sgm_reference(tl, tr, params))
    print(f"time stereo_sgm end to end: {e2e:.4f} ms/frame, "
          f"{h * w * d / (e2e * 1e3):.1f} Mpixel*disp/s; plain pipeline "
          f"{e2e_plain:.4f} ms/frame ({h}x{w}x{d}; {card_line})")
    lv_args = (census_transform(f1, fparams.census_window),
               census_transform(f2, fparams.census_window))
    bu = torch.ones((fh, fw), dtype=torch.int32, device=dev)

    def flow_cost():
        return cost_volume_flow_major(*lv_args, bu, -bu,
                                      fparams.search_radius,
                                      fparams.invalid_cost, nl_pad=nd_f)

    print(f"flow cost build at level 0 (label-major, {nd_f} slots): "
          f"{device_launches(flow_cost)} device launches, "
          f"{median_ms(flow_cost):.4f} ms; census of one image: "
          f"{device_launches(lambda: census_transform(f1))} launches "
          f"({card_line})")
    fe2e = median_ms(lambda: flow_fsgm(f1, f2, fparams))
    fe2e_plain = median_ms(lambda: flow_fsgm_reference(f1, f2, fparams),
                           reps=3, warmup=1)
    print(f"time flow_fsgm end to end: {fe2e:.4f} ms/frame; plain pipeline "
          f"{fe2e_plain:.4f} ms/frame ({fh}x{fw}, config 4: "
          f"{dataclasses.asdict(fparams)}; {card_line})")

    # the batched path: K1, K2, K3 over its 16 frames, then ms and launches
    # per frame of stereo_sgm_batch at B=1 and B=16
    bl, br = frame_stack(h, w, d, BATCH, SEED, dev)
    bcl = census_transform(bl, params.census_window)
    bcr = census_transform(br, params.census_window)
    bcost_args = (bcl, bcr, d, params.invalid_cost)
    bc = cost.census_cost(*bcost_args)
    bp2es = [agg.p2_effective(bl, r, params.p1, params.p2,
                              params.adaptive_p2) for r in params.dirs]

    def bsweeps(plain: bool = False):
        if plain:
            return sum(agg.sgm_sweep_plain(bc, p2e, r, params.p1)
                       for r, p2e in zip(params.dirs, bp2es)).to(s_dtype)
        s = None
        for r, p2e in zip(params.dirs, bp2es):
            s = agg.sgm_sweep(bc, p2e, r, params.p1, s=s, s_dtype=s_dtype)
        return s

    bext_args = (bsweeps(), params.s_invalid, params.lr_max_diff,
                 params.subpixel)
    bhw = BATCH * hw
    bwork = {
        "census_cost": (
            lambda: cost.census_cost(*bcost_args),
            lambda: cost.census_cost_plain(*bcost_args),
            (BATCH * (2 * hw * 8 + hw * d), 3 * bhw * d)),
        "sgm_sweep": (
            bsweeps, lambda: bsweeps(plain=True),
            (bhw * d + n_dirs * bhw * 4 + bhw * d * s_bytes,
             8 * n_dirs * bhw * d)),
        "extract_stereo": (
            lambda: extract.extract_stereo(*bext_args),
            lambda: extract.extract_stereo_plain(*bext_args),
            (bhw * d * s_bytes + 5 * bhw * 4, 6 * bhw * d)),
    }
    btimes = {}
    for name, (kern, plain, (nbytes, nops)) in bwork.items():
        plain_ms = median_ms(plain, reps=3, warmup=1)
        torch.cuda.empty_cache()
        ms = median_ms(kern)
        b_ms, b_by = bound(nbytes, nops)
        btimes[name] = dict(frames=BATCH, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(f"time {name} batched: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} "
              f"B, {nops} ops) ({BATCH} frames of {(h, w, d)}; "
              f"{card_line})")
    del bc, bp2es, bext_args
    torch.cuda.empty_cache()
    per_frame = {}
    for b in (1, BATCH):
        fl, fr = bl[:b].contiguous(), br[:b].contiguous()
        _build.LAUNCHES.clear()
        stereo_sgm_batch(fl, fr, params)
        torch.cuda.synchronize()
        k_launches = sum(_build.LAUNCHES.values()) / b
        dev_launches = device_launches(
            lambda: stereo_sgm_batch(fl, fr, params)) / b
        ms = median_ms(lambda: stereo_sgm_batch(fl, fr, params), reps=5) / b
        per_frame[b] = dict(ms=ms, device_launches=dev_launches,
                            kernel_launches=k_launches)
        print(f"time stereo_sgm_batch B={b}: {ms:.4f} ms/frame, "
              f"{h * w * d / (ms * 1e3):.1f} Mpixel*disp/s, "
              f"{dev_launches:.2f} device launches/frame, {k_launches:.4f} "
              f"kernel-wrapper launches/frame ({h}x{w}x{d}; {card_line})")
    print(f"batched path per frame, B=1 vs B={BATCH}: "
          f"{json.dumps(per_frame)} ({card_line})")

    rows = []
    for name, (lib, replaces, also, paths) in SOURCES.items():
        row = {"name": name, "route": "cuda",
               "source": f"fsgm_tpu_torch/csrc/{lib}.cu",
               "replaces": replaces,
               "launches": launches[paths[0]].get(name, 0),
               "max_abs_err": errs[name], **times[name]}
        if also:
            row["also_replaces"] = also
        if len(paths) > 1:
            row["launches_by_path"] = {p: launches[p].get(name, 0)
                                       for p in paths}
        if name == "sgm_sweep":  # the row's times: 1D labels, stereo frame
            row["label_2d"] = times["sgm_sweep_2d"]
        if name in btimes:  # the same kernel over the batched path's frames
            row["batch"] = btimes[name]
        rows.append(row)

    foreign = foreign_modules()
    require(not foreign, f"the run loaded {foreign}")
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
