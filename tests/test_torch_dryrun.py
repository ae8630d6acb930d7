"""PyTorch port: the dry run (parallel/dryrun.py), the counterpart of
tests/distributed/test_graft_entry.py, on CPU devices.

dryrun_multichip(n) runs every parallelism mode over n devices and raises
unless each exact mode equals its untiled counterpart bit for bit
(tolerance 0); entry() gives stereo_sgm at Tsukuba size.  Without a card
the default device raises instead of falling back to the CPU.
"""

import pytest
import torch

from fsgm_tpu_torch.parallel.dryrun import dryrun_multichip, entry


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the cores, and these
    tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [8, 4, 3, 2, 1])
def test_dryrun_multichip(n):
    dryrun_multichip(n, device="cpu")


def test_entry_runs():
    fn, args = entry(device="cpu")
    out = fn(*args)
    assert tuple(out.shape) == (288, 384)
    assert bool((out >= -1).all()) and bool((out >= 0).any())


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
