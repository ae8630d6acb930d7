"""PyTorch port: tiled fSGM flow (fsgm_tpu_torch.parallel.flow_fsgm_sharded)
on the CPU, where every tile takes the kernels' plain versions.

Exact mode equals the port's untiled flow_fsgm (flow and validity plane,
bit for bit) for row tiles and frame shards and for every fb_backward mode;
fast mode with a margin of the whole tile and two tiles equals it too.
fb_grid="half", which the reference silently checks on the full grid under
tiling, raises.  The comparison with the JAX package's flow_fsgm_sharded
is in test_torch_tiled_api.py.  The kernels run on the card in the `cuda`
test at the end and in chip_smoke.py phase 8.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fsgm_tpu_torch import DistParams, FlowParams, flow_fsgm, \
    flow_fsgm_sharded
from fsgm_tpu_torch.io import blockwise_flow_pair

P = FlowParams(search_radius=2, levels=3, p1=7, p2=60)


def _pairs(h, w, seeds):
    got = [blockwise_flow_pair(h, w, 3, seed=s)[:2] for s in seeds]
    return (torch.from_numpy(np.stack([g[0] for g in got])),
            torch.from_numpy(np.stack([g[1] for g in got])))


@pytest.fixture(scope="module")
def pairs():
    return _pairs(48, 64, (8, 9))


def _untiled(i1, i2, p):
    got = [flow_fsgm(a, b, p) for a, b in zip(i1, i2)]
    return torch.stack([g[0] for g in got]), torch.stack([g[1] for g in got])


@pytest.mark.parametrize("frame,ty", [(1, 4), (2, 2)])
def test_exact_equals_untiled(pairs, frame, ty):
    i1, i2 = pairs
    counters = {}
    flow, valid = flow_fsgm_sharded(i1, i2, P, DistParams(
        tiles_y=ty, frame_shards=frame), counters=counters)
    want, want_valid = _untiled(i1, i2, P)
    assert flow.dtype == torch.float32 and flow.shape == want.shape
    assert torch.equal(flow, want) and torch.equal(valid, want_valid)
    assert valid.any() and not valid.all()
    assert counters["bytes"]["carry"] > 0 and counters["bytes"]["gather"] > 0


@pytest.mark.parametrize("mode", ["cheap", "single", "half"])
def test_backward_modes_equal_untiled(pairs, mode):
    i1, i2 = pairs
    p = dataclasses.replace(P, fb_backward=mode)
    flow, valid = flow_fsgm_sharded(i1[:1], i2[:1], p, DistParams(tiles_y=4))
    want, want_valid = flow_fsgm(i1[0], i2[0], p)
    assert torch.equal(flow[0], want) and torch.equal(valid[0], want_valid)


def test_fast_whole_tile_margin_two_tiles(pairs):
    """Two tiles and a margin of the whole tile: the one carry handed on is
    the true one, so fast mode is exact."""
    i1, i2 = pairs
    flow, valid = flow_fsgm_sharded(i1[1:], i2[1:], P, DistParams(
        tiles_y=2, tile_mode="fast", margin=1000))
    want, want_valid = flow_fsgm(i1[1], i2[1], P)
    assert torch.equal(flow[0], want) and torch.equal(valid[0], want_valid)


@pytest.mark.parametrize("bad", ["fb_grid", "rows", "tiles_x"])
def test_rejects(pairs, bad):
    """fb_grid="half" (checked on the full grid by the reference under
    tiling) raises, as do rows that the pyramid's tiles do not divide and
    column tiles."""
    i1, i2 = pairs
    p, dist = P, DistParams(tiles_y=2)
    if bad == "fb_grid":
        p = dataclasses.replace(P, fb_grid="half")
    elif bad == "rows":
        dist = DistParams(tiles_y=5)
    else:
        dist = DistParams(tiles_x=2)
    with pytest.raises(ValueError):
        flow_fsgm_sharded(i1, i2, p, dist)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tiled_flow_kernels_equal_untiled_on_the_card(pairs, card):
    i1, i2 = (x.to(card) for x in pairs)
    p = dataclasses.replace(P, adaptive_p2=True)
    flow, valid = flow_fsgm_sharded(i1, i2, p, DistParams(
        tiles_y=2, frame_shards=2))
    want, want_valid = _untiled(i1, i2, p)
    assert torch.equal(flow, want) and torch.equal(valid, want_valid)
