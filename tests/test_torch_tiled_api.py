"""PyTorch port: the tiled entry points (fsgm_tpu_torch.parallel) against
the JAX package's own, and their interface, on the CPU.

Tiled stereo in fast mode at margin 8 (an approximation) equals the JAX
package's stereo_sgm_sharded (backend "xla", one module-scoped call) bit
for bit, and tiled flow in exact mode equals one JAX flow_fsgm_sharded
call.  The counters show the wavefront's work and the carries handed
across the seams, counted on one device as on many; a device per tile is
taken in (frame, ty, tx) order; fill_invalid, which the reference ignores
under tiling, raises; utils/profiling.py profiles the tiled pipeline.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fsgm_tpu.params import DistParams as JDistParams
from fsgm_tpu.params import FlowParams as JFlowParams
from fsgm_tpu.params import SGMParams as JSGMParams
from fsgm_tpu.parallel.tiled import stereo_sgm_sharded as jax_sharded
from fsgm_tpu.parallel.tiled_flow import \
    flow_fsgm_sharded as jax_flow_sharded
from fsgm_tpu_torch import (DistParams, FlowParams, SGMParams, stereo_sgm,
                            flow_fsgm_sharded, stereo_sgm_sharded,
                            stereo_sgm_sharded_reference)
from fsgm_tpu_torch.io import blockwise_flow_pair, random_dot_stereo

P = SGMParams(max_disp=16, p1=7, p2=60)


@pytest.fixture(scope="module")
def pairs():
    got = [random_dot_stereo(48, 64, 16, seed=s) for s in (11, 12)]
    return (torch.from_numpy(np.stack([g[0] for g in got])),
            torch.from_numpy(np.stack([g[1] for g in got])))


@pytest.fixture(scope="module")
def jax_fast8(pairs):
    """The JAX package's tiled stereo, fast mode, margin 8, 4 row tiles on
    4 of the virtual CPU devices (backend "xla")."""
    il, ir = pairs
    mesh = jax.make_mesh((1, 4), ("frame", "ty"), devices=jax.devices()[:4])
    p = JSGMParams(max_disp=16, p1=7, p2=60)
    dist = JDistParams(tiles_y=4, tile_mode="fast", margin=8)
    return np.asarray(jax_sharded(jnp.asarray(il[:1].numpy()),
                                  jnp.asarray(ir[:1].numpy()), p, dist, mesh,
                                  backend="xla"))[0]


def test_fast_margin8_equals_jax(pairs, jax_fast8):
    il, ir = pairs
    counters = {}
    out = stereo_sgm_sharded(il[:1], ir[:1], P, DistParams(
        tiles_y=4, tile_mode="fast", margin=8), counters=counters)[0]
    np.testing.assert_array_equal(out.numpy(), jax_fast8)
    # an approximation: it differs from the untiled result somewhere
    assert not torch.equal(out, stereo_sgm(il[0], ir[0], P))
    # pass 1 over each 12-row tile, pass 2 over its first / last 8 rows
    h, t, m = 48, 4, 8
    for fam in ("down", "up"):
        assert sum(counters["rows"][fam]) == h + t * m
        assert len(counters["rows"][fam]) == 2 * t


@pytest.mark.parametrize("frame,ty", [(1, 4), (2, 2)])
def test_exact_counters(pairs, frame, ty):
    """Each row swept once per family in a chain of t active calls, and one
    (B, 2, W, D) int32 carry per vertical direction handed across each of
    the t - 1 seams of each shard, counted on one device as on many."""
    il, ir = pairs
    counters = {}
    stereo_sgm_sharded(il, ir, P, DistParams(
        tiles_y=ty, frame_shards=frame, tile_mode="exact"),
        counters=counters)
    f, h, w = il.shape
    b = f // frame
    for fam in ("down", "up"):
        assert sum(counters["rows"][fam]) == frame * h
        assert len(counters["rows"][fam]) == frame * ty
    vertical = sum(1 for r in P.dirs if r[0] != 0)
    per_seam = vertical * 2 * w * P.max_disp * 4 * b
    assert counters["bytes"]["carry"] == frame * (ty - 1) * per_seam


def test_devices_and_reference(pairs):
    """An explicit device per tile (frame, ty, tx order; nested or flat),
    and the plain twin, which is the same code on CPU tensors."""
    il, ir = pairs
    dist = DistParams(tiles_y=2, frame_shards=2)
    cpu = torch.device("cpu")
    out = stereo_sgm_sharded(il, ir, P, dist, devices=[[[cpu], [cpu]]] * 2)
    assert torch.equal(out, stereo_sgm_sharded_reference(
        il, ir, P, dist, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="devices"):
        stereo_sgm_sharded(il, ir, P, dist, devices=[cpu] * 3)


@pytest.mark.parametrize("bad", ["fill_invalid", "frames", "rows", "shape"])
def test_rejects(pairs, bad):
    """fill_invalid, ignored by the reference under tiling, raises here;
    so do shapes the tile grid does not divide."""
    il, ir = pairs
    p, dist = P, DistParams(tiles_y=2)
    if bad == "fill_invalid":
        p = dataclasses.replace(P, fill_invalid=True)
    elif bad == "frames":
        dist = DistParams(frame_shards=3)
    elif bad == "rows":
        dist = DistParams(tiles_y=5)
    else:
        il = il[0]
    with pytest.raises(ValueError):
        stereo_sgm_sharded(il, ir, p, dist)


def test_profiling_the_tiled_pipeline(capsys):
    """utils/profiling.py --pipeline tiled: config 5's distribution over
    two frames, numbers per frame (on the CPU: the ops' self time)."""
    import json
    from fsgm_tpu_torch.utils.profiling import main
    assert main(["--pipeline", "tiled", "--device", "cpu", "--height", "8",
                 "--width", "24", "--batch", "2", "--tile-mode", "exact",
                 "--calls", "1", "--warmup", "0"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["pipeline"] == "tiled" and rec["frames_per_call"] == 2
    assert rec["dist"]["tile_mode"] == "exact"
    assert rec["dist"]["tiles_y"] == 4 and rec["dist"]["frame_shards"] == 2
    assert rec["busy_ms"] > 0 and rec["launches"] > 0


def test_flow_equals_jax_flow_fsgm_sharded():
    """Exact mode, 32x64, two levels, radius 2, two row tiles on 2 of the
    virtual CPU devices (backend "xla")."""
    i1, i2 = (torch.from_numpy(x[None])
              for x in blockwise_flow_pair(32, 64, 3, seed=4)[:2])
    p = FlowParams(search_radius=2, levels=2, p1=7, p2=60)
    mesh = jax.make_mesh((1, 2), ("frame", "ty"), devices=jax.devices()[:2])
    want, want_valid = jax_flow_sharded(
        jnp.asarray(i1.numpy()), jnp.asarray(i2.numpy()),
        JFlowParams(search_radius=2, levels=2, p1=7, p2=60),
        JDistParams(tiles_y=2, tile_mode="exact"), mesh, backend="xla")
    flow, valid = flow_fsgm_sharded(i1, i2, p, DistParams(tiles_y=2))
    np.testing.assert_array_equal(flow.numpy(), np.asarray(want))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
