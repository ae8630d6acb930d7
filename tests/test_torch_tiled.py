"""PyTorch port: tiled stereo (fsgm_tpu_torch.parallel.stereo_sgm_sharded)
on the CPU, where every tile takes the kernels' plain versions.

Exact mode equals the port's untiled stereo for row tiles, frame shards,
column windows, 16 paths with adaptive P2 and lr_mode="reagg"; fast mode
equals it at the auto margin where the tiles are at least that tall or
there are two tiles.  The comparison with the JAX package's tiled stereo,
the counters, devices and refusals are in test_torch_tiled_api.py.  The
kernels run on the card in the `cuda` test at the end and in
chip_smoke.py phase 8.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fsgm_tpu_torch import (DistParams, SGMParams, stereo_sgm,
                            stereo_sgm_batch, stereo_sgm_sharded,
                            stereo_sgm_sharded_reference)
from fsgm_tpu_torch.io import random_dot_stereo
from fsgm_tpu_torch.params import forgetting_margin

P = SGMParams(max_disp=16, p1=7, p2=60)


def _pairs(h, w, seeds, d=16):
    got = [random_dot_stereo(h, w, d, seed=s) for s in seeds]
    return (torch.from_numpy(np.stack([g[0] for g in got])),
            torch.from_numpy(np.stack([g[1] for g in got])))


@pytest.fixture(scope="module")
def pairs():
    return _pairs(48, 64, (11, 12))


@pytest.mark.parametrize("frame,ty", [(1, 4), (2, 2)])
@pytest.mark.parametrize("num_paths,adaptive", [(8, False), (16, True)])
def test_exact_rows_equal_untiled(pairs, frame, ty, num_paths, adaptive):
    p = dataclasses.replace(P, num_paths=num_paths, adaptive_p2=adaptive)
    il, ir = pairs
    out = stereo_sgm_sharded(il, ir, p, DistParams(
        tiles_y=ty, frame_shards=frame, tile_mode="exact"))
    assert out.dtype == torch.float32 and out.shape == il.shape
    assert torch.equal(out, stereo_sgm_batch(il, ir, p))


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_column_windows_equal_untiled(pairs, mode):
    """(ty, tx) = (2, 2): margin windows with columns outside the image on
    both sides, bit-exact at the auto margin in both modes."""
    il, ir = pairs
    dist = DistParams(tiles_y=2, tiles_x=2, tile_mode=mode)
    out = stereo_sgm_sharded(il[:1], ir[:1], P, dist)
    assert torch.equal(out[0], stereo_sgm(il[0], ir[0], P))


@pytest.mark.parametrize("tx", [1, 2])
def test_reagg_equals_untiled(pairs, tx):
    p = dataclasses.replace(P, lr_mode="reagg")
    il, ir = pairs
    dist = DistParams(tiles_y=4 // tx, tiles_x=tx, tile_mode="exact")
    out = stereo_sgm_sharded(il[1:], ir[1:], p, dist)
    assert torch.equal(out[0], stereo_sgm(il[1], ir[1], p))


def test_fast_exact_at_the_forgetting_margin():
    """Tiles of 64 rows, taller than forgetting_margin (45 rows): the auto
    margin is exact, and fewer rows give more differing pixels; with two
    tiles a margin of the whole tile is exact too."""
    il, ir = _pairs(128, 64, (13,))
    ref = stereo_sgm(il[0], ir[0], P)
    bound = forgetting_margin(P.p1, P.p2, cmax=P.invalid_cost)
    assert bound == 45
    differ = {}
    for margin in (1, 8, 0, 1000):
        out = stereo_sgm_sharded(il, ir, P, DistParams(
            tiles_y=2, tile_mode="fast", margin=margin))[0]
        differ[margin] = float((out != ref).float().mean())
    assert differ[0] == differ[1000] == 0.0, differ
    assert differ[1] >= differ[8] >= differ[0], differ


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tiled_kernels_equal_untiled_on_the_card(card):
    """The kernels take D a multiple of 32."""
    il, ir = (x.to(card) for x in _pairs(48, 64, (11, 12), d=32))
    p = SGMParams(max_disp=32, p1=7, p2=60, num_paths=16, adaptive_p2=True)
    for dist in (DistParams(tiles_y=4, frame_shards=2),
                 DistParams(tiles_y=2, tiles_x=2, tile_mode="fast")):
        assert torch.equal(stereo_sgm_sharded(il, ir, p, dist),
                           stereo_sgm_batch(il, ir, p))
    dist = DistParams(tiles_y=4, tile_mode="fast", margin=8)
    assert torch.equal(stereo_sgm_sharded(il, ir, p, dist),
                       stereo_sgm_sharded_reference(il, ir, p, dist))
