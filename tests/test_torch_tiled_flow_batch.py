"""PyTorch port: the tiled flow's frame axis (fsgm_tpu_torch.parallel.
flow_fsgm_sharded runs a frame shard's frames as one pass through its chain
of row tiles, both passes of a level in lockstep) on the CPU, where every
tile takes the kernels' plain versions.

Frames of different content, each first image's last row bright and the
next frame's first row dark, so that a row leaking from one frame into
another shows.  Each frame of a pass equals the port's untiled flow_fsgm
bit for bit (flow and validity plane):

  * exact mode over 3 frames at 2 and 4 row tiles and over 4 frames on
    2 frame shards x 2 tiles, and every fb_backward mode over 2 frames on
    2 tiles;
  * fast mode with a margin of the whole tile over 2 frames;
  * one row tile on 2 shards: each shard is flow_fsgm_batch, and
    fb_grid="half" is accepted there;
  * ``chunk`` 1, 2 and None give the same frames and chunk 0 raises; the
    bytes handed between tiles (``counters``) of a pass equal the sum over
    calls of one frame each;
  * 2 frames equal one call of the JAX package's flow_fsgm_sharded (xla
    backend, exact mode, a (1, 2) mesh) bit for bit;
  * on the card (`cuda`, skipped here): the kernels' pass over 3 frames
    equal to per-frame flow_fsgm.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fsgm_tpu_torch import (DistParams, FlowParams, flow_fsgm,
                            flow_fsgm_batch, flow_fsgm_sharded)
from fsgm_tpu_torch.io import blockwise_flow_pair

P = FlowParams(search_radius=2, levels=3, p1=7, p2=60)
HW = (48, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the cores, and these
    tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(h, w, seeds):
    """Pairs of different content; frame k's last rows bright and frame
    k + 1's first rows dark, in both images."""
    got = [blockwise_flow_pair(h, w, 3, seed=s)[:2] for s in seeds]
    i1, i2 = (np.stack([g[k] for g in got]) for k in (0, 1))
    for img in (i1, i2):
        img[:-1, -1] = 255
        img[1:, 0] = 0
    return torch.from_numpy(i1), torch.from_numpy(i2)


@pytest.fixture(scope="module")
def frames():
    return _frames(*HW, (20, 21, 22, 23))


def _untiled(i1, i2, p):
    got = [flow_fsgm(a, b, p) for a, b in zip(i1, i2)]
    return torch.stack([g[0] for g in got]), torch.stack([g[1] for g in got])


def _equal(got, want):
    assert got[0].shape == want[0].shape and got[0].dtype == torch.float32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_exact_equals_flow_fsgm(frames):
    """3 frames at 2 and 4 row tiles (one shard: one pass of 3), 4 frames
    on 2 shards x 2 tiles (two passes of 2)."""
    i1, i2 = frames
    want = _untiled(i1, i2, P)
    assert want[1].any() and not want[1].all()
    for n, dist in ((3, DistParams(tiles_y=2)), (3, DistParams(tiles_y=4)),
                    (4, DistParams(tiles_y=2, frame_shards=2))):
        _equal(flow_fsgm_sharded(i1[:n], i2[:n], P, dist),
               (want[0][:n], want[1][:n]))


@pytest.mark.parametrize("mode", ["full", "cheap", "single", "half"])
def test_backward_modes_equal_flow_fsgm(frames, mode):
    i1, i2 = (x[1:3] for x in frames)
    p = dataclasses.replace(P, fb_backward=mode)
    _equal(flow_fsgm_sharded(i1, i2, p, DistParams(tiles_y=2)),
           _untiled(i1, i2, p))


def test_fast_whole_tile_margin(frames):
    """Two tiles and a margin of the whole tile: the one carry handed on is
    the true one, so fast mode is exact, over 2 frames a pass."""
    i1, i2 = (x[2:] for x in frames)
    _equal(flow_fsgm_sharded(i1, i2, P, DistParams(
        tiles_y=2, tile_mode="fast", margin=1000)), _untiled(i1, i2, P))


def test_one_tile_shards_are_flow_fsgm_batch(frames):
    """tiles_y = 1 on 2 shards: each shard is flow_fsgm_batch over its
    frames (any H: 45 rows divide by no pyramid), fb_grid="half" taken."""
    i1, i2 = (x[:, :45] for x in frames)
    p = dataclasses.replace(P, fb_backward="half", fb_grid="half")
    counters = {}
    got = flow_fsgm_sharded(i1, i2, p, DistParams(frame_shards=2),
                            counters=counters, chunk=2)
    for a in (0, 2):
        _equal((got[0][a:a + 2], got[1][a:a + 2]),
               flow_fsgm_batch(i1[a:a + 2], i2[a:a + 2], p))
    assert counters == {}


def test_chunk_and_counters(frames):
    """chunk 1, 2 and None over a shard of 4 frames at 2 tiles: the same
    frames; 3 is rounded down to 2 and 0 raises.  The bytes handed between
    tiles in one call equal the sum over one-frame calls."""
    i1, i2 = frames
    dist = DistParams(tiles_y=2)
    per_frame = {}
    for a, b in zip(i1, i2):
        c = {}
        flow_fsgm_sharded(a[None], b[None], P, dist, counters=c)
        for kind, n in c["bytes"].items():
            per_frame[kind] = per_frame.get(kind, 0) + n
    assert per_frame["carry"] > 0 and per_frame["halo"] > 0 \
        and per_frame["gather"] > 0
    want = None
    for chunk in (None, 1, 2, 3):
        counters = {}
        got = flow_fsgm_sharded(i1, i2, P, dist, counters=counters,
                                chunk=chunk)
        assert counters["bytes"] == per_frame
        if want is None:
            want = got
        _equal(got, want)
    _equal(want, _untiled(i1, i2, P))
    with pytest.raises(ValueError, match="chunk"):
        flow_fsgm_sharded(i1, i2, P, dist, chunk=0)


def test_two_frames_equal_jax_flow_fsgm_sharded():
    """Exact mode, 2 frames of 32x64, two levels, radius 2, two row tiles
    on 2 of the virtual CPU devices (backend "xla").  JAX is imported
    here, not with the module, so that the card's tests below run without
    it."""
    import jax
    import jax.numpy as jnp
    from fsgm_tpu.params import DistParams as JDistParams
    from fsgm_tpu.params import FlowParams as JFlowParams
    from fsgm_tpu.parallel.tiled_flow import \
        flow_fsgm_sharded as jax_flow_sharded
    i1, i2 = _frames(32, 64, (4, 5))
    kw = dict(search_radius=2, levels=2, p1=7, p2=60)
    mesh = jax.make_mesh((1, 2), ("frame", "ty"), devices=jax.devices()[:2])
    want, want_valid = jax_flow_sharded(
        jnp.asarray(i1.numpy()), jnp.asarray(i2.numpy()), JFlowParams(**kw),
        JDistParams(tiles_y=2, tile_mode="exact"), mesh, backend="xla")
    flow, valid = flow_fsgm_sharded(i1, i2, FlowParams(**kw),
                                    DistParams(tiles_y=2))
    assert np.asarray(want_valid).any()
    np.testing.assert_array_equal(flow.numpy(), np.asarray(want))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tiled_pass_kernels_equal_flow_fsgm_on_the_card(frames, card):
    i1, i2 = (x[:3].to(card) for x in frames)
    p = dataclasses.replace(P, adaptive_p2=True)
    _equal(flow_fsgm_sharded(i1, i2, p, DistParams(tiles_y=4)),
           _untiled(i1, i2, p))
