"""PyTorch port: `cli video`, read_flo and the fractional-shift generators.

  * `cli video --device cpu` over tests/fixtures/flow_seq_3frame.npz's
    frames (radius 2, 2 levels): the .flo files equal the fixture's flows
    (0 where invalid) within 1e-3, the PNGs carry its valid masks;
  * --track-levels 1 equals flow_sequence with track_params;
  * the port's and the JAX package's read_flo agree on files either
    package wrote, and both refuse a bad magic;
  * fractional_shift_stereo and fractional_flow_pair are bit for bit the
    JAX package's for two seeds;
  * the port's subpixel stage beats integer WTA on fractional pairs
    (the counterpart of tests/unit/test_subpixel_accuracy.py).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fsgm_tpu.io import kitti as jax_kitti
from fsgm_tpu.io import synthetic as jax_synthetic
from fsgm_tpu_torch import FlowParams, SGMParams, flow_fsgm, stereo_sgm
from fsgm_tpu_torch.cli.main import main
from fsgm_tpu_torch.io import (fractional_flow_pair, fractional_shift_stereo,
                               read_flo, read_flow_png, save_gray,
                               write_flo)
from fsgm_tpu_torch.models.flow import flow_sequence

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "flow_seq_3frame.npz"
TOL = 1e-3


def _video(tmp_path, capsys, frames, *flags):
    names = []
    for t, f in enumerate(frames):
        save_gray(tmp_path / f"f{t}.png", f)
        names.append(str(tmp_path / f"f{t}.png"))
    (tmp_path / "frames.txt").write_text("\n".join(names) + "\n")
    out = tmp_path / "out"
    assert main(["video", str(tmp_path / "frames.txt"), "-o", str(out),
                 "--search-radius", "2", "--levels", "2", "--device", "cpu",
                 *flags]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    return out, recs


@pytest.mark.parametrize("fmt", ["flo", "png"])
def test_cli_video_matches_the_fixture(tmp_path, capsys, fmt):
    fx = np.load(FIXTURE)
    out, recs = _video(tmp_path, capsys, fx["frames"], "--format", fmt)
    pairs = fx["flows"].shape[0]
    assert recs[-1]["cmd"] == "video" and recs[-1]["pairs"] == pairs
    for t in range(pairs):
        valid = fx["valids"][t]
        assert recs[t] == {"cmd": "video", "pair": t,
                           "out": str(out / f"f{t}"),
                           "valid_frac": round(float(valid.mean()), 4)}
        want = np.where(valid[..., None], fx["flows"][t], 0)
        if fmt == "flo":
            got = read_flo(out / f"f{t}.flo")
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=TOL)
        else:
            got, got_valid = read_flow_png(out / f"f{t}.png")
            np.testing.assert_array_equal(got_valid, valid)
            np.testing.assert_allclose(got[valid], want[valid], atol=1 / 64)


def test_cli_video_track_levels_equals_flow_sequence(tmp_path, capsys):
    fx = np.load(FIXTURE)
    out, _ = _video(tmp_path, capsys, fx["frames"], "--format", "flo",
                    "--track-levels", "1")
    p = FlowParams(search_radius=2, levels=2)
    flows, valids = flow_sequence(torch.from_numpy(fx["frames"]), p,
                                  track_params=dataclasses.replace(
                                      p, levels=1))
    for t in range(flows.shape[0]):
        want = torch.where(valids[t][..., None], flows[t], 0.0).numpy()
        np.testing.assert_array_equal(read_flo(out / f"f{t}.flo"), want)


def test_read_flo_agrees_with_jax(tmp_path):
    rng = np.random.default_rng(4)
    flow = rng.normal(size=(7, 11, 2)).astype(np.float32)
    write_flo(tmp_path / "port.flo", flow)
    jax_kitti.write_flo(tmp_path / "jax.flo", flow)
    assert ((tmp_path / "port.flo").read_bytes()
            == (tmp_path / "jax.flo").read_bytes())
    for name in ("port.flo", "jax.flo"):
        ours = read_flo(tmp_path / name)
        np.testing.assert_array_equal(ours, jax_kitti.read_flo(
            tmp_path / name))
        np.testing.assert_array_equal(ours, flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 20)
    for reader in (read_flo, jax_kitti.read_flo):
        with pytest.raises(ValueError, match="magic"):
            reader(tmp_path / "bad.flo")


@pytest.mark.parametrize("seed", [0, 7])
def test_fractional_generators_equal_jax(seed):
    for ours, want in (
            (fractional_shift_stereo(40, 56, 6.4, seed=seed),
             jax_synthetic.fractional_shift_stereo(40, 56, 6.4, seed=seed)),
            (fractional_flow_pair(40, 56, 2.45, -1.6, seed=seed),
             jax_synthetic.fractional_flow_pair(40, 56, 2.45, -1.6,
                                                seed=seed))):
        for a, b in zip(ours, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("disp", [6.4, 9.7])
def test_stereo_subpixel_beats_integer_wta(disp):
    img_l, img_r, gt = fractional_shift_stereo(64, 96, disp, seed=3)
    base = SGMParams(max_disp=24, p1=7, p2=60, lr_check=False,
                     median_filter=False)
    errs = {}
    for sub in (False, True):
        d = stereo_sgm(torch.from_numpy(img_l), torch.from_numpy(img_r),
                       dataclasses.replace(base, subpixel=sub)).numpy()
        interior = np.zeros_like(d, dtype=bool)
        interior[8:-8, 32:-8] = True          # clear of the border ramp
        errs[sub] = float(np.abs(d - gt)[interior].mean())
    # the margins of tests/unit/test_subpixel_accuracy.py
    frac = abs(disp - round(disp))
    assert errs[False] >= 0.8 * frac, errs
    assert errs[True] <= 0.85 * errs[False], errs
    assert errs[True] < 0.30, errs


def test_flow_subpixel_beats_integer_wta():
    img1, img2, gt = fractional_flow_pair(72, 96, 2.45, -1.6, seed=5)
    base = FlowParams(levels=2, search_radius=4, p1=7, p2=60,
                      fb_check=False, median_filter=False)
    errs = {}
    for sub in (False, True):
        flo, _ = flow_fsgm(torch.from_numpy(img1), torch.from_numpy(img2),
                           dataclasses.replace(base, subpixel=sub))
        epe = np.sqrt(((flo.numpy() - gt) ** 2).sum(-1))
        errs[sub] = float(epe[8:-8, 8:-8].mean())
    assert errs[True] <= 0.75 * errs[False], errs
    assert errs[True] < 0.45, errs
