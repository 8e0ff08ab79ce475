"""The port's native frame IO (``active_orb_slam2_tpu_torch/io/native.py``):
the cases of ``tests/test_native_io.py`` on the port's binding, which
builds ``native/frameio.cpp`` into its own git-ignored directory; and
the JAX package's decoder beside it on the same files."""

import os

import numpy as np
import pytest

from active_orb_slam2_tpu_torch.io import native as tnative
from active_orb_slam2_tpu_torch.io.native import (
    PrefetchingReader, build_native, decode_gray)


@pytest.fixture(scope="module")
def png_files(tmp_path_factory, ):
    from PIL import Image
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("imgs")
    paths = {}
    g8 = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    Image.fromarray(g8, "L").save(d / "gray8.png")
    paths["gray8"] = (str(d / "gray8.png"), g8)
    rgb = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    Image.fromarray(rgb, "RGB").save(d / "rgb.png")
    paths["rgb"] = (str(d / "rgb.png"), rgb)
    d16 = rng.integers(0, 60000, (24, 36)).astype(np.uint16)
    Image.fromarray(d16, "I;16").save(d / "depth16.png")
    paths["depth16"] = (str(d / "depth16.png"), d16)
    # PGM binary
    pgm = rng.integers(0, 256, (20, 30), dtype=np.uint8)
    with open(d / "img.pgm", "wb") as f:
        f.write(b"P5\n30 20\n255\n" + pgm.tobytes())
    paths["pgm"] = (str(d / "img.pgm"), pgm)
    return paths


def test_build_native():
    """The library lands in the port's build directory, not in
    ``native/``."""
    assert build_native(), "native build failed"
    so = tnative._so_path()
    assert os.path.exists(so)
    assert os.path.dirname(so) == tnative._BUILD_DIR
    assert tnative._lib() is not None


def test_decode_gray8(png_files):
    path, truth = png_files["gray8"]
    got = decode_gray(path)
    np.testing.assert_array_equal(got, truth)


def test_decode_rgb_to_gray(png_files):
    path, rgb = png_files["rgb"]
    got = decode_gray(path)
    want = (rgb[..., 0].astype(int) * 299 + rgb[..., 1].astype(int) * 587
            + rgb[..., 2].astype(int) * 114) // 1000
    assert got.shape == rgb.shape[:2]
    assert np.abs(got.astype(int) - want).max() <= 1


def test_decode_depth16(png_files):
    path, truth = png_files["depth16"]
    got = decode_gray(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, truth)


def test_decode_pgm(png_files):
    path, truth = png_files["pgm"]
    got = decode_gray(path)
    np.testing.assert_array_equal(got, truth)


def test_prefetching_reader(png_files):
    path8, g8 = png_files["gray8"]
    paths = [path8] * 12
    reader = PrefetchingReader(paths, prefetch=4, threads=3)
    frames = list(reader)
    reader.close()
    assert len(frames) == 12
    for f in frames:
        np.testing.assert_array_equal(f, g8)


def test_prefetcher_mixed_sequence(png_files):
    """Different sizes/depths in one sequence decode in order."""
    seq = [png_files["gray8"][0], png_files["depth16"][0],
           png_files["pgm"][0]]
    reader = PrefetchingReader(seq, prefetch=2, threads=2)
    out = list(reader)
    reader.close()
    assert out[0].shape == (48, 64)
    assert out[1].dtype == np.uint16
    assert out[2].shape == (20, 30)


def test_decoders_match_jax(png_files):
    """The port's decoder gives the JAX package's arrays on every file."""
    from active_orb_slam2_tpu.io.native import decode_gray as j_decode
    for path, _ in png_files.values():
        got, want = decode_gray(path), j_decode(path)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
