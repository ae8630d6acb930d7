"""PyTorch port: the PGM and PFM helpers (fsgm_tpu_torch/io/images.py)
against the JAX package's (fsgm_tpu/io/images.py), in both directions.

Each file is written by one package and read by the other, on images made
from a seed; every comparison is exact (integer pixels, float32 maps bit
for bit).  The model is tests/unit/test_aux.py::test_pgm_pfm_roundtrip.
"""

import numpy as np
import pytest

from fsgm_tpu.io import images as jax_images
from fsgm_tpu_torch import io


@pytest.fixture
def rng():
    return np.random.default_rng(2026)


@pytest.mark.parametrize("writer,reader", [
    (io.write_pgm, jax_images.read_pgm), (jax_images.write_pgm, io.read_pgm),
    (io.write_pgm, io.read_pgm)])
def test_p5_pgm_both_ways(tmp_path, rng, writer, reader):
    img = rng.integers(0, 256, (17, 23)).astype(np.uint8)
    writer(tmp_path / "x.pgm", img)
    got = reader(tmp_path / "x.pgm")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)


def test_p2_and_16_bit_pgm(tmp_path, rng):
    """ASCII P2 with a comment line, and 16-bit P5 (big-endian samples,
    maxval 65535) and P2 (maxval 1000), each rescaled by * 255 // maxval;
    the two packages agree on every file."""
    a = rng.integers(0, 256, (5, 7))
    p2 = tmp_path / "a.pgm"
    p2.write_text("P2\n# a comment\n7 5\n255\n"
                  + "\n".join(" ".join(map(str, r)) for r in a) + "\n")
    b = rng.integers(0, 65536, (6, 9)).astype(">u2")
    p5 = tmp_path / "b.pgm"
    p5.write_bytes(b"P5\n9 6\n65535\n" + b.tobytes())
    c = rng.integers(0, 1001, (4, 3))
    p2w = tmp_path / "c.pgm"
    p2w.write_text("P2 3 4 1000\n" + " ".join(map(str, c.ravel())) + "\n")
    for path, want in ((p2, a), (p5, b.astype(np.int64) * 255 // 65535),
                       (p2w, c * 255 // 1000)):
        got = io.read_pgm(path)
        np.testing.assert_array_equal(got, want.astype(np.uint8))
        np.testing.assert_array_equal(got, jax_images.read_pgm(path))


@pytest.mark.parametrize("shape", [(9, 11), (6, 8, 3)])
def test_pfm_both_ways(tmp_path, rng, shape):
    """1-channel (Pf) and 3-channel (PF) maps, bottom-up, little-endian:
    each package reads the other's file bit for bit."""
    f = rng.normal(size=shape).astype(np.float32)
    io.write_pfm(tmp_path / "port.pfm", f)
    jax_images.write_pfm(tmp_path / "jax.pfm", f)
    assert ((tmp_path / "port.pfm").read_bytes()
            == (tmp_path / "jax.pfm").read_bytes())
    for got in (io.read_pfm(tmp_path / "jax.pfm"),
                jax_images.read_pfm(tmp_path / "port.pfm")):
        assert got.shape == shape
        np.testing.assert_array_equal(got, f)


def test_big_endian_pfm_and_refusals(tmp_path, rng):
    """A positive scale means big-endian samples; a file of another format
    raises in both readers."""
    f = rng.normal(size=(4, 5)).astype(np.float32)
    path = tmp_path / "be.pfm"
    path.write_bytes(b"Pf\n5 4\n1.0\n" + f[::-1].astype(">f4").tobytes())
    got = io.read_pfm(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, f)
    np.testing.assert_array_equal(got, jax_images.read_pfm(path))
    bad = tmp_path / "bad"
    bad.write_bytes(b"P6\n1 1\n255\n\0\0\0")
    for reader in (io.read_pgm, io.read_pfm, jax_images.read_pgm,
                   jax_images.read_pfm):
        with pytest.raises(ValueError):
            reader(bad)
