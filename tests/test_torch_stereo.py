"""PyTorch port: the stereo main path end to end and its imports.

  * stereo_sgm on the CPU vs JAX stereo_sgm(..., "pallas_tr") (interpret
    mode) and golden/sgm.py::sgm_stereo: invalid mask identical, valid
    disparity within 1e-3 (f32 subpixel vs golden's f64);
  * vs the frozen fixtures (tests/fixtures, params from
    tools/freeze_fixtures.py): cost, S and d_int exact, disp within 1e-3;
  * stereo_sgm_batch == per-frame stereo_sgm; importing the port loads no
    module of jax, fsgm_tpu or golden; lr_mode="reagg" and fill_invalid are
    honoured, not substituted (golden/sgm.py).
The CLI and the profiler are tested in test_torch_cli.py, the presets and
parameter classes in test_torch_presets.py.
The kernels themselves are checked on the card by chip_smoke.py and by the
`cuda`-marked test here, which skips without a card.
"""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden.sgm as g
from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu.models.stereo import stereo_sgm as jax_stereo_sgm
import fsgm_tpu_torch
from fsgm_tpu_torch import (SGMParams, stereo_sgm, stereo_sgm_batch,
                            stereo_sgm_reference)
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.kernels import aggregate, cost, extract

REPO = Path(__file__).resolve().parents[1]
FIXDIR = REPO / "tests" / "fixtures"
sys.path.insert(0, str(REPO / "tools"))
import freeze_fixtures as ff  # noqa: E402

TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_disp_close(ours, want):
    np.testing.assert_array_equal(ours < 0, want < 0)
    both = ours >= 0
    np.testing.assert_allclose(ours[both], want[both], atol=TOL)


@pytest.fixture(scope="module")
def small_pair():
    il, ir, _ = random_dot_stereo(40, 56, 16, seed=7)
    p = SGMParams(max_disp=16, p1=7, p2=60)
    jax_disp = np.asarray(jax_stereo_sgm(jnp.asarray(il), jnp.asarray(ir),
                                         p, "pallas_tr"))
    return il, ir, p, jax_disp


def test_stereo_matches_jax_pallas_tr_and_golden(small_pair):
    il, ir, p, jax_disp = small_pair
    ours = stereo_sgm(_t(il), _t(ir), p)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == il.shape
    ours = ours.numpy()
    _assert_disp_close(ours, jax_disp)
    _assert_disp_close(ours, g.sgm_stereo(il, ir, p))


def test_reference_pipeline_matches_kernel_path_on_cpu(small_pair):
    il, ir, p, _ = small_pair
    np.testing.assert_array_equal(
        stereo_sgm(_t(il), _t(ir), p).numpy(),
        stereo_sgm_reference(_t(il), _t(ir), p).numpy())


@pytest.mark.parametrize("name", ["stereo_8path", "stereo_16path_adaptive"])
def test_matches_frozen_fixture(name):
    _, _, d, _, kw = ff.STEREO_CASES[name]
    fx = np.load(FIXDIR / f"{name}.npz")
    p = SGMParams(**kw)
    il, ir = _t(fx["img_l"]), _t(fx["img_r"])
    c = cost.census_cost(census_transform(il, p.census_window),
                         census_transform(ir, p.census_window), d,
                         p.invalid_cost)
    np.testing.assert_array_equal(c.numpy(), fx["cost"])
    s = aggregate.aggregate_paths(c, il, p.dirs, p.p1, p.p2, p.adaptive_p2,
                                  s_max=p.s_invalid)
    np.testing.assert_array_equal(s.numpy().astype(np.int32), fx["S"])
    d_int = extract.extract_stereo(s, p.s_invalid, p.lr_max_diff)[0]
    np.testing.assert_array_equal(d_int.numpy(), fx["d_int"])
    _assert_disp_close(stereo_sgm(il, ir, p).numpy(), fx["disp"])


def test_batch_equals_per_frame():
    p = SGMParams(max_disp=16, p1=7, p2=60)
    pairs = [random_dot_stereo(24, 40, 16, seed=k) for k in range(3)]
    imgs_l = _t(np.stack([a for a, _, _ in pairs]))
    imgs_r = _t(np.stack([b for _, b, _ in pairs]))
    batch = stereo_sgm_batch(imgs_l, imgs_r, p)
    assert tuple(batch.shape) == (3, 24, 40)
    for k in range(3):
        np.testing.assert_array_equal(
            batch[k].numpy(), stereo_sgm(imgs_l[k], imgs_r[k], p).numpy())


@pytest.mark.parametrize("kw", [dict(lr_mode="reagg"),
                                dict(fill_invalid=True)])
def test_unported_options_are_refused(kw):
    """Once refused, now ported: each option runs and gives golden's
    result, which differs from the result without it (so it is not
    silently dropped)."""
    il, ir, _ = random_dot_stereo(20, 36, 16, seed=9)
    p = SGMParams(max_disp=16, p1=7, p2=60, **kw)
    ours = stereo_sgm(_t(il), _t(ir), p).numpy()
    _assert_disp_close(ours, g.sgm_stereo(il, ir, p))
    plain = stereo_sgm(_t(il), _t(ir), SGMParams(max_disp=16, p1=7,
                                                 p2=60)).numpy()
    assert not np.array_equal(ours, plain)


def test_importing_the_port_never_loads_jax():
    """Every module of the port, imported in a fresh interpreter, loads no
    module of jax, of the JAX package or of golden/."""
    mods = [m.name for m in pkgutil.walk_packages(
        fsgm_tpu_torch.__path__, "fsgm_tpu_torch.")
        if not m.name.endswith("__main__")]
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    roots = ("jax", "fsgm_tpu", "golden")
    foreign = [m for m in loaded
               if m in roots or m.startswith(tuple(r + "." for r in roots))]
    assert len(mods) >= 15 and "fsgm_tpu_torch.models.flow" in loaded
    assert {"fsgm_tpu_torch.parallel.tiled",
            "fsgm_tpu_torch.parallel.tiled_flow"} <= set(loaded)
    assert foreign == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card(card):
    il, ir, _ = random_dot_stereo(37, 53, 32, seed=5)
    p = SGMParams(max_disp=32, p1=7, p2=60, adaptive_p2=True, num_paths=16)
    tl, tr = _t(il).to(card), _t(ir).to(card)
    ours = stereo_sgm(tl, tr, p).cpu().numpy()
    _assert_disp_close(ours, stereo_sgm_reference(tl, tr, p).cpu().numpy())
    _assert_disp_close(ours, g.sgm_stereo(il, ir, p))
