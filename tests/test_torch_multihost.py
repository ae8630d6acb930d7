"""PyTorch port: execution across torch.distributed ranks
(parallel/multihost.py, parallel/ranks.py, utils/logging.py, `cli
scale-test`) on the CPU.

  * global_mesh's rank layout (frame = world x frame_per_process, ty =
    devices_per_proc / frame_per_process, the devices of each rank) and its
    refusals;
  * weak_scaling_report, host_prefix and log_record equal the JAX
    package's functions;
  * a world-size-1 gloo group in this process: stereo_sgm_sharded and
    flow_fsgm_sharded with a RankMesh equal the same calls over a device
    list, and a RankMesh that does not match the frame axis raises;
  * two gloo ranks as processes at tests/distributed/test_multihost.py's
    shapes (32x48, D=16, 4 row tiles a rank, exact): each frame equals JAX
    stereo_sgm, every rank returns the same result and loads no module of
    jax, fsgm_tpu or golden; the same for flow against the port's
    flow_fsgm;
  * `cli scale-test --device cpu --procs 2 --reps 1` prints one JSON line
    (marked `slow`: two launches of ranks), and exits without a card by
    default; a rank's failure fails the launch.
Every comparison is exact (tolerance 0).  Each launch has its own timeout
(RANK_TIMEOUT_S), and the rendezvous takes a free port.
"""

import io as pyio
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fsgm_tpu.models.stereo import stereo_sgm as jax_stereo_sgm
from fsgm_tpu.params import SGMParams as JSGMParams
from fsgm_tpu.parallel import multihost as jax_multihost
from fsgm_tpu.utils import logging as jax_logging
from fsgm_tpu_torch import (DistParams, FlowParams, SGMParams, flow_fsgm,
                            flow_fsgm_sharded, stereo_sgm_sharded)
from fsgm_tpu_torch.cli.main import main
from fsgm_tpu_torch.io import constant_flow_pair, random_dot_stereo
from fsgm_tpu_torch.parallel import multihost, ranks
from fsgm_tpu_torch.utils import logging as port_logging

RANK_TIMEOUT_S = 120.0
P = SGMParams(max_disp=16, p1=7, p2=60)
FP = FlowParams(search_radius=2, levels=2, p1=7, p2=60)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (and one a CPU rank): the suite's workers share
    the cores, and these tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_rank(monkeypatch, rank, world):
    """This process seen as rank ``rank`` of ``world`` by both packages."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)


def _pairs(make, n, *args):
    got = [make(*args, seed=s) for s in range(n)]
    return (torch.from_numpy(np.stack([g[0] for g in got])),
            torch.from_numpy(np.stack([g[1] for g in got])))


def test_global_mesh_layout(monkeypatch):
    m = multihost.global_mesh(device="cpu")
    assert (m.rank, m.world, m.frame, m.ty) == (0, 1, 1, 1)
    assert m.devices == (torch.device("cpu"),)
    _as_rank(monkeypatch, 1, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    m = multihost.global_mesh(frame_per_process=2, devices_per_proc=4)
    assert (m.rank, m.world, m.frame, m.ty, m.frame_per_process) == \
        (1, 2, 4, 2, 2)
    assert m.devices == (torch.device("cuda", 0),) * 4  # ranks share a card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    m = multihost.global_mesh(devices_per_proc=4)
    assert m.devices == tuple(torch.device("cuda", i) for i in range(4, 8))


def test_global_mesh_refusals(monkeypatch):
    for fpp, dpp in ((2, 3), (0, 1), (1, 0)):
        with pytest.raises(ValueError):
            multihost.global_mesh(fpp, dpp, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.global_mesh()
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["scale-test"])


def test_report_and_logging_equal_jax(monkeypatch):
    for args in ((7.5, 2, 4.0), (3.0, 4, 0.0)):
        assert multihost.weak_scaling_report(*args) == \
            jax_multihost.weak_scaling_report(*args)
    for rank, world in ((0, 1), (1, 2)):
        _as_rank(monkeypatch, rank, world)
        assert port_logging.host_prefix() == jax_logging.host_prefix()
        lines = []
        for mod in (port_logging, jax_logging):
            buf = pyio.StringIO()
            mod.log_record(buf, frame=3, ts=1.5, wall_s=0.25)
            lines.append(buf.getvalue())
        assert lines[0] == lines[1]
    assert port_logging.host_prefix() == "[host 1/2] "
    assert json.loads(lines[0])["host"] == "host 1/2"
    logger = port_logging.get_logger("fsgm_torch_multihost_test")
    try:
        assert logger.handlers[0].formatter._fmt.startswith("[host 1/2] ")
    finally:
        logger.handlers.clear()
        logging.Logger.manager.loggerDict.pop(logger.name, None)


@pytest.fixture
def group():
    """A world-size-1 gloo group in this process, destroyed afterwards."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_rank_mesh_in_one_rank(group):
    """The RankMesh path of both entry points (one rank, the gather over
    the world of one) equals the same call over a device list."""
    mesh = multihost.global_mesh(frame_per_process=2, devices_per_proc=4,
                                 device="cpu")
    il, ir = _pairs(random_dot_stereo, 2, 32, 48, 16)
    dp = DistParams(tiles_y=2, frame_shards=2)
    assert torch.equal(stereo_sgm_sharded(il, ir, P, dp, mesh),
                       stereo_sgm_sharded(il, ir, P, dp, ["cpu"] * 4))
    i1, i2 = _pairs(constant_flow_pair, 2, 32, 48, 1, -1)
    got = flow_fsgm_sharded(i1, i2, FP, dp, mesh)
    want = flow_fsgm_sharded(i1, i2, FP, dp)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="frame axis"):
        stereo_sgm_sharded(il, ir, P, DistParams(tiles_y=2), mesh)
    with pytest.raises(ValueError):
        stereo_sgm_sharded(il[:1], ir[:1], P, dp, mesh)


def _run(task, params, a, b, inputs, out, tiles=4):
    dp = DistParams(tiles_y=tiles, frame_shards=2, tile_mode="exact")
    return ranks.run_spec(task, params, dp, a, b, inputs, out,
                          devices_per_proc=tiles)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One job on two gloo ranks: stereo, then flow, on 2 frames each."""
    tmp = tmp_path_factory.mktemp("ranks")
    il, ir = _pairs(random_dot_stereo, 2, 32, 48, 16)
    i1, i2 = _pairs(constant_flow_pair, 2, 32, 48, 1, -1)
    job = {"device": "cpu", "timeout_s": RANK_TIMEOUT_S, "runs": [
        _run("stereo", P, il, ir, tmp / "s.npz", tmp / "s_out.npz"),
        _run("flow", FP, i1, i2, tmp / "f.npz", tmp / "f_out.npz")]}
    reports = ranks.launch(job, 2)
    assert [r["rank"] for r in reports] == [0, 1]
    assert all(r["foreign"] == [] for r in reports)
    return reports, tmp, (il, ir), (i1, i2)


@pytest.mark.parametrize("run", [0, 1])
def test_every_rank_returns_the_same_frames(two_ranks, run):
    reports = two_ranks[0]
    assert len({r["runs"][run]["digest"] for r in reports}) == 1
    assert all(r["runs"][run]["frames"] == 2 for r in reports)


def test_two_ranks_stereo_equal_jax(two_ranks):
    _, tmp, (il, ir), _ = two_ranks
    got = np.load(tmp / "s_out.npz")["out"]
    jp = JSGMParams(max_disp=16, p1=7, p2=60)
    for k in range(2):
        want = np.asarray(jax_stereo_sgm(jnp.asarray(il[k].numpy()),
                                         jnp.asarray(ir[k].numpy()), jp))
        np.testing.assert_array_equal(got[k], want)


def test_two_ranks_flow_equal_flow_fsgm(two_ranks):
    _, tmp, _, (i1, i2) = two_ranks
    got = np.load(tmp / "f_out.npz")
    for k in range(2):
        flow, valid = flow_fsgm(i1[k], i2[k], FP)
        np.testing.assert_array_equal(got["out"][k], flow.numpy())
        np.testing.assert_array_equal(got["valid"][k], valid.numpy())


@pytest.mark.slow
def test_scale_test_cli(capsys):
    """Two launches (1 rank, then 2): 5 s alone, 30 s beside the suite's
    other workers, hence `slow`; chip_smoke.py phase 11 runs the command
    on the card."""
    assert main(["scale-test", "--device", "cpu", "--procs", "2",
                 "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rep = json.loads(lines[0])
    assert rep["hosts"] == 2 and rep["device"] == "cpu"
    assert rep["frames_per_s"] > 0 and rep["frames_per_s_1host"] > 0
    assert "weak_scaling_efficiency" in rep


def test_a_failing_rank_fails_the_launch(tmp_path):
    """A run whose frame_shards (2) is not the world's frame axis (1): the
    rank raises, and launch raises with its error well inside the
    timeout."""
    il, ir = _pairs(random_dot_stereo, 2, 16, 24, 8)
    job = {"device": "cpu", "timeout_s": RANK_TIMEOUT_S, "runs": [
        _run("stereo", SGMParams(max_disp=8), il, ir, tmp_path / "in.npz",
             tmp_path / "out.npz", tiles=1)]}
    with pytest.raises(RuntimeError, match="ValueError: frame_shards"):
        ranks.launch(job, 1)
