"""PyTorch port: K3's right-view pass (wta_right) and the kernels that the
JAX package's "minor" extraction (FSGM_EXTRACT=minor) routes to.

Plain versions (the CPU path of each wrapper) against the JAX package:

  * K3's right-view pass, wta_right, against fsgm_tpu/ops/pallas/
    extract_tr.py::wta_right_major in interpret mode (tests/conftest.py sets
    FSGM_PALLAS_INTERPRET=1), odd W, and against the diag_min_packed
    harness of tests/unit/test_property.py (a single small pallas_call);
  * K3 without the right-view pass against fsgm_tpu/ops/pallas/
    extract_pallas.py::wta_neighborhood: d* and S[d*] everywhere, S[d*-1]
    and S[d*+1] on the interior (wta_neighborhood gives 0 at the label
    edges, K3 gives BIG; callers read neither);
  * K1 against fsgm_tpu/ops/pallas/cost_pallas.py::cost_volume_stereo with
    5x5 and 9x7 census;
  * the "minor" composition (K3 without the right view, the parabola,
    wta_right, lr_check) against K3's one pass and against JAX
    wta_right_from_s and lr_check on the same S.  The port's stereo paths
    run K3's one pass: the composition gives the same disparity and is
    slower on the card (PERF.md).

The kernels themselves run on the card (the `cuda` test at the end and
chip_smoke.py phase 9).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import golden.sgm as g
from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu.ops import census as jcensus
from fsgm_tpu.ops import extract as jext
from fsgm_tpu.ops.pallas import cost_pallas, extract_pallas, extract_tr
from fsgm_tpu_torch import SGMParams, stereo_sgm
from fsgm_tpu_torch.ops import extract as ext
from fsgm_tpu_torch.ops.census import census_transform
from fsgm_tpu_torch.ops.kernels import aggregate as agg
from fsgm_tpu_torch.ops.kernels import cost, extract, probe

TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_wta_right_matches_wta_right_major():
    """Odd W and odd H, label-minor S vs the JAX label-major kernel."""
    rng = np.random.default_rng(47)
    s = rng.integers(0, 2900, (15, 33, 32)).astype(np.int16)
    want = extract_tr.wta_right_major(
        jnp.transpose(jnp.asarray(s), (0, 2, 1)), 30000)
    got = extract.wta_right(_t(s), 30000)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(extract.wta_right_plain(_t(s), 30000), got)


def test_k3_without_rwta_matches_wta_neighborhood():
    """#12: d*, S[d*] everywhere (ties included), S[d*-1] / S[d*+1] on the
    interior; at the label edges wta_neighborhood gives 0, K3 BIG."""
    nd = 32
    rng = np.random.default_rng(11)
    s = rng.integers(0, 2840, (12, 40, nd)).astype(np.int16)
    s[3, 5, :] = 7        # ties: the smallest d wins
    s[4, 6, 0] = 0        # d* = 0
    s[5, 7, nd - 1] = 0   # d* = D - 1
    want = [np.asarray(x) for x in
            extract_pallas.wta_neighborhood(jnp.asarray(s))]
    d, s_m, s_0, s_p, valid = extract.extract_stereo(_t(s), 2841,
                                                     with_rwta=False)
    assert valid is None
    np.testing.assert_array_equal(d.numpy(), want[0])
    np.testing.assert_array_equal(s_0.numpy(), want[2])
    d = d.numpy()
    interior = (d > 0) & (d < nd - 1)
    assert not interior.all()
    np.testing.assert_array_equal(s_m.numpy()[interior], want[1][interior])
    np.testing.assert_array_equal(s_p.numpy()[interior], want[3][interior])
    assert (want[1][d == 0] == 0).all() and (want[3][d == nd - 1] == 0).all()
    assert (s_m.numpy()[d == 0] == ext.BIG).all()
    assert (s_p.numpy()[d == nd - 1] == ext.BIG).all()


@pytest.mark.parametrize("window", [(5, 5), (9, 7)])
def test_census_cost_matches_cost_pallas(window):
    """#11: K1's left-reference cost from the port's one-word census equals
    the JAX binary-shear kernel on its multi-word census."""
    il, ir, _ = random_dot_stereo(24, 40, 16, seed=2)
    want = cost_pallas.cost_volume_stereo(
        jcensus.census_transform(jnp.asarray(il), window),
        jcensus.census_transform(jnp.asarray(ir), window), 16)
    got = cost.census_cost(census_transform(_t(il), window),
                           census_transform(_t(ir), window), 16)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wta_right_matches_diag_min_packed_harness():
    """#17: tests/unit/test_property.py's harness runs diag_min_packed, the
    fused shear + min of the right-view WTA, as one pallas_call.  It kills
    the entries with x + d >= W (KILL), where the port puts s_invalid: with
    every S below s_invalid the d = 0 entry always beats s_invalid, so the
    two agree on both the argmin and the minimum."""
    s_invalid = 1 << 20
    for w, nl, seed in ((33, 24, 1), (8, 40, 2), (40, 3, 3)):
        rng = np.random.default_rng(seed)
        v = rng.integers(0, s_invalid, (nl, w)).astype(np.int32)
        v[:, 5] = v[0, 5]  # ties along one column
        packed = (v << 8) | np.arange(nl, dtype=np.int32)[:, None]

        def kernel(p_ref, o_ref):
            o_ref[...] = extract_tr.diag_min_packed(p_ref[...], w)

        got = np.asarray(pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((1, w), jnp.int32),
            interpret=True)(jnp.asarray(packed)))[0]
        s = _t(v.T[None])                        # (1, W, D) label-minor
        rho = extract.wta_right(s, s_invalid)[0].numpy()
        np.testing.assert_array_equal(rho, got & 255)
        np.testing.assert_array_equal(v[rho, np.arange(w) + rho], got >> 8)


@pytest.mark.parametrize("h,w,paths,adaptive", [(48, 64, 8, False),
                                                 (48, 64, 16, True),
                                                 (31, 47, 8, True)])
def test_minor_extraction_equals_kernel_and_jax(h, w, paths, adaptive):
    """On the S of a random-dot pair (D = 32): K3 without the right-view
    pass gives K3's d*, S[d*-1], S[d*], S[d*+1]; the parabola, wta_right
    and lr_valid on them give K3's validity plane bit for bit (JAX:
    got_minor == ref in tests/unit/test_extract_major.py); wta_right
    equals JAX wta_right_from_s, and lr_check equals JAX lr_check within
    1e-3 with the same invalid mask."""
    il, ir, _ = random_dot_stereo(h, w, 32, seed=13)
    p = SGMParams(max_disp=32, p1=7, p2=60, adaptive_p2=adaptive,
                  num_paths=paths)
    c = cost.census_cost(census_transform(_t(il)), census_transform(_t(ir)),
                         32, p.invalid_cost)
    s = agg.aggregate_paths(c, _t(il), p.dirs, p.p1, p.p2, p.adaptive_p2,
                            p.s_invalid)
    *left, valid = extract.extract_stereo(s, p.s_invalid, p.lr_max_diff)
    *minor, none = extract.extract_stereo(s, p.s_invalid, with_rwta=False)
    assert none is None
    assert all(torch.equal(a, b) for a, b in zip(left, minor))
    disp = ext.subpixel_from_neighborhood(*minor, 32)
    rho = extract.wta_right(s, p.s_invalid)
    assert torch.equal(ext.lr_valid(disp, rho, p.lr_max_diff, 32),
                       valid.bool())
    np.testing.assert_array_equal(
        rho.numpy(), np.asarray(jext.wta_right_from_s(jnp.asarray(s.numpy()),
                                                      p.s_invalid)))
    ours = ext.lr_check(disp, rho, p.lr_max_diff, 32).numpy()
    want = np.asarray(jext.lr_check(jnp.asarray(disp.numpy()),
                                    jnp.asarray(rho.numpy()), p.lr_max_diff,
                                    32))
    np.testing.assert_array_equal(ours == ext.INVALID, want == ext.INVALID)
    assert (ours == ext.INVALID).any() and (ours != ext.INVALID).any()
    both = ours != ext.INVALID
    np.testing.assert_allclose(ours[both], want[both], atol=TOL)


def test_rejects_and_probe_plain():
    """A bad S raises; min_probe's plain version on the CPU is
    torch.minimum for every form."""
    with pytest.raises(TypeError):
        extract.wta_right(torch.zeros((4, 6, 32), dtype=torch.float32), 900)
    with pytest.raises(ValueError):
        extract.wta_right(torch.zeros((4, 6, 32), dtype=torch.int16), 1 << 22)
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(-999, 999, (64, 256))
                             .astype(np.int16)) for _ in range(2))
    for form in probe.FORMS:
        x, y = (a, b) if form != "int32" else (a.int(), b.int())
        assert torch.equal(probe.min_probe(x, y, form), torch.minimum(x, y))
    with pytest.raises(TypeError):
        probe.min_probe(a.int(), b.int(), "packed")
    with pytest.raises(ValueError):
        probe.min_probe(a, b, "vmin")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_minor_kernels_match_plain_on_the_card(card):
    """K3's right-view pass against its plain version (int16 and int32,
    two frames, odd W, D = 32 and 96, ties), the min16_probe forms against
    torch.minimum, and stereo_sgm's invalid mask equal to golden's."""
    rng = np.random.default_rng(0)
    for nd, dtype in ((32, torch.int16), (96, torch.int32)):
        s = torch.from_numpy(rng.integers(0, 6, (2, 7, 45, nd))).to(dtype)
        s = s.to(card)
        assert torch.equal(extract.wta_right(s, 900),
                           extract.wta_right_plain(s, 900))
    a, b = (torch.from_numpy(rng.integers(-30000, 30000, 4098)
                             .astype(np.int16)).to(card) for _ in range(2))
    for form in probe.FORMS:
        x, y = (a, b) if form != "int32" else (a.int(), b.int())
        assert torch.equal(probe.min_probe(x, y, form), torch.minimum(x, y))
    il, ir, _ = random_dot_stereo(37, 53, 32, seed=5)
    tl, tr = _t(il).to(card), _t(ir).to(card)
    p = SGMParams(max_disp=32, p1=7, p2=60, adaptive_p2=True, num_paths=16)
    ours = stereo_sgm(tl, tr, p).cpu().numpy()
    want = g.sgm_stereo(il, ir, p)
    np.testing.assert_array_equal(ours < 0, want < 0)
