"""On-card smoke run of the PyTorch port (fsgm_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each of which raises on failure (non-zero exit, no ok line):

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the three kernels from fsgm_tpu_torch/csrc with nvcc;
  2. each kernel against its plain PyTorch version on the card, exact, at
     the KITTI shape (375x1242, D=128, random-dot pair) and at 37x53, D=32;
  3. stereo_sgm end to end against stereo_sgm_reference (plain versions
     only): identical invalid mask, valid disparities within 1e-3, D1-all
     against the ground truth, and each kernel's launch count in that call;
  4. stereo_sgm_batch on 4 frames equals per-frame stereo_sgm;
  5. CUDA-event timings (median of 10 runs after warm-up): end to end and
     each kernel against its plain version (sgm_sweep: the frame's 8
     launches over prebuilt P2' tables).

The run fails if anything in it loaded jax.  The last lines are the per-kernel JSON record, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

KITTI = (375, 1242, 128)
SMALL = (37, 53, 32)
SEED = 0
DISP_TOL = 1e-3  # f32 subpixel: both sides use the same IEEE formula
SOURCES = {
    "census_cost": ("cost", "fsgm_tpu/ops/pallas/cost_tr.py:106",
                    "fsgm_tpu/ops/pallas/cost_tr.py:264"),
    "sgm_sweep": ("sgm_sweep", "fsgm_tpu/ops/pallas/aggregate_tr.py:289",
                  None),
    "extract_stereo": ("extract", "fsgm_tpu/ops/pallas/extract_tr.py:227",
                       None),
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


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


def max_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def pair(h, w, d, seed, dev):
    from fsgm_tpu_torch.io import random_dot_stereo
    il, ir, gt = random_dot_stereo(h, w, d, seed=seed)
    return (torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev), gt)


def check_kernels(shape, params, dev, dirs, tag: str) -> dict:
    """Each kernel against its plain version on one input; returns the
    largest absolute error per kernel (all must be 0)."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from fsgm_tpu_torch import (DIRS_16, SGMParams, load_preset, stereo_sgm,
                                stereo_sgm_batch, stereo_sgm_reference)
    from fsgm_tpu_torch.eval import d1_all
    from fsgm_tpu_torch.ops.census import census_transform
    from fsgm_tpu_torch.ops.kernels import _build, cost, extract
    from fsgm_tpu_torch.ops.kernels import aggregate as agg

    # 0. the card
    dev = torch.device("cuda")
    card_line = card()
    kind = torch.cuda.get_device_name(0)
    print(card_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 1. build
    for name, (lib, _, _) in SOURCES.items():
        t0 = time.perf_counter()
        _build.load(lib)
        print(f"build {name} ({lib}.cu): "
              f"{time.perf_counter() - t0:.2f} s")

    # 2. kernels against their plain versions
    params = load_preset("configs/kitti_stereo.json")["sgm"]
    errs = check_kernels(KITTI, params, dev, params.dirs, "kitti")
    small = SGMParams(max_disp=SMALL[2], p1=7, p2=60, adaptive_p2=True,
                      num_paths=16)
    check_kernels(SMALL, small, dev, DIRS_16, "37x53 16-path adaptive")
    wide = SGMParams(max_disp=SMALL[2], p2=7000)  # s_invalid >= 2^15: int32 S
    check_kernels(SMALL, wide, dev, wide.dirs, "37x53 int32 S")
    check_extract_ties(dev)

    # 3. the main path end to end, launches counted in this call only
    h, w, d = KITTI
    tl, tr, gt = pair(h, w, d, SEED, dev)
    _build.LAUNCHES.clear()
    disp = stereo_sgm(tl, tr, params)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"launches in one stereo_sgm call: {launches}")
    for name in SOURCES:
        require(launches.get(name, 0) > 0, f"{name} not launched")
    ref = stereo_sgm_reference(tl, tr, params)
    require(tuple(disp.shape) == (h, w) and bool(torch.isfinite(disp).all()),
            "disparity shape / finiteness")
    require(torch.equal(disp < 0, ref < 0), "invalid mask != plain")
    both = (disp >= 0) & (ref >= 0)
    derr = float((disp[both] - ref[both]).abs().max())
    require(derr <= DISP_TOL, f"disparity error {derr} > {DISP_TOL}")
    m = d1_all(disp.cpu().numpy(), gt.astype(np.float64))
    print(f"end to end vs plain: invalid mask equal, max |disp err| {derr}; "
          f"D1-all {m['d1_all']:.4f} EPE {m['epe']:.4f} "
          f"density {m['density']:.4f}")

    # 4. batch == per-frame
    frames = [pair(h, w, d, SEED + k, dev) for k in range(4)]
    imgs_l = torch.stack([f[0] for f in frames])
    imgs_r = torch.stack([f[1] for f in frames])
    batch = stereo_sgm_batch(imgs_l, imgs_r, params)
    per = torch.stack([stereo_sgm(a, b, params)
                       for a, b in zip(imgs_l, imgs_r)])
    require(torch.equal(batch, per), "stereo_sgm_batch != per-frame")
    print("stereo_sgm_batch (4 frames) == per-frame stereo_sgm")

    # 5. timings at the KITTI shape, each kernel on the main path's inputs;
    # sgm_sweep is the frame's sweeps over P2' tables built beforehand
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
    timing = {
        "census_cost": (lambda: cost.census_cost(*cost_args),
                        lambda: cost.census_cost_plain(*cost_args)),
        "sgm_sweep": (sweeps, sweeps_plain),
        "extract_stereo": (lambda: extract.extract_stereo(*ext_args),
                           lambda: extract.extract_stereo_plain(*ext_args)),
    }
    rows = []
    for name, (kern, plain) in timing.items():
        lib, replaces, also = SOURCES[name]
        plain_ms = median_ms(plain)
        ms = median_ms(kern)
        row = {"name": name, "route": "cuda",
               "source": f"fsgm_tpu_torch/csrc/{lib}.cu",
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms}
        if also:
            row["also_replaces"] = also
        rows.append(row)
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"({h}x{w}x{d}; {card_line})")
    e2e = median_ms(lambda: stereo_sgm(tl, tr, params))
    e2e_plain = median_ms(lambda: stereo_sgm_reference(tl, tr, params))
    rate = h * w * d / (e2e * 1e3)
    print(f"time stereo_sgm end to end: {e2e:.4f} ms/frame, "
          f"{rate:.1f} Mpixel*disp/s; plain pipeline {e2e_plain:.4f} "
          f"ms/frame ({h}x{w}x{d}; {card_line})")

    require("jax" not in sys.modules, "the run loaded jax")
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
