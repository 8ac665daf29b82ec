"""The port's C++ mask decoder (``pnpinversion_tpu_torch/data/_native.py``,
``csrc/data_ops.cpp``) against the JAX package's (``pnpinversion_tpu/data/_native.py``)
and against the numpy decode, bit for bit; the resize against its plain
double arithmetic; and a failed build, which raises."""
from __future__ import annotations

import numpy as np
import pytest

from pnpinversion_tpu.data import _native as jnative
from pnpinversion_tpu.data import pie_bench as jpb
from pnpinversion_tpu_torch.data import _native, pie_bench
from pnpinversion_tpu_torch.ops import build


def _random_pairs(rng, length: int, n: int) -> np.ndarray:
    """n seeded [start, len] pairs inside the buffer, overlapping, some of
    length 0, the last cut by the end of the buffer."""
    starts = rng.randint(0, length, n)
    runs = rng.randint(0, length // 8, n)
    starts[-1], runs[-1] = length - 7, 100
    return np.stack([starts, runs], axis=1).astype(np.int64)


@pytest.mark.parametrize("seed,shape", [(0, (512, 512)), (1, (512, 512)), (2, (64, 80)),
                                        (3, (64, 64))])
def test_rle_decode_bit_identical(seed, shape):
    """Random pairs and a run cut at the image's end: the port's decoder,
    the JAX package's and the numpy decode give the same f64 buffer."""
    assert jnative.available()
    length = shape[0] * shape[1]
    enc = _random_pairs(np.random.RandomState(seed), length, 40)
    got = _native.rle_decode(enc, length)
    assert got.dtype == np.float64 and got.shape == (length,)
    np.testing.assert_array_equal(got, jnative.rle_decode(enc, length))
    np.testing.assert_array_equal(got, pie_bench.rle_decode_reference(enc, length))
    assert got[-7:].all() and 0 < got.mean() < 1


@pytest.mark.parametrize("shape", [(512, 512), (64, 64), (63, 64)])
def test_mask_decode_takes_the_decoder_at_the_threshold(monkeypatch, shape):
    """``mask_decode`` calls the C++ decoder from 4096 pixels on (the JAX
    package's threshold) and the numpy decode below, and equals JAX's."""
    rng = np.random.RandomState(5)
    length = shape[0] * shape[1]
    rle = [int(x) for x in _random_pairs(rng, length, 12).reshape(-1)]
    calls = []
    decode = _native.rle_decode
    monkeypatch.setattr(_native, "rle_decode", lambda *a: calls.append(a) or decode(*a))
    got = pie_bench.mask_decode(rle, shape)
    assert len(calls) == (length >= 4096)
    np.testing.assert_array_equal(got, jpb.mask_decode(rle, shape))


@pytest.mark.parametrize("src,dst", [((37, 53, 3), (64, 48)), ((512, 512, 3), (300, 211))])
def test_resize_bilinear_is_its_double_arithmetic(src, dst):
    """The bilinear resize equals its formula in numpy f64 bit for bit (the
    port builds without FMA contraction), and the JAX package's build within
    one level (it builds with -march=native, which may contract)."""
    img = (np.random.RandomState(7).rand(*src) * 255).astype(np.uint8)
    got = _native.resize_bilinear(img, *dst)
    (sh, sw, _), (dh, dw) = src, dst
    fy = (np.arange(dh) + 0.5) * (sh / dh) - 0.5
    fx = (np.arange(dw) + 0.5) * (sw / dw) - 0.5
    y0 = np.maximum(0, fy.astype(np.int64))
    x0 = np.maximum(0, fx.astype(np.int64))
    y1, x1 = np.minimum(sh - 1, y0 + 1), np.minimum(sw - 1, x0 + 1)
    wy = np.maximum(fy - y0, 0)[:, None, None]
    wx = np.maximum(fx - x0, 0)[None, :, None]
    f = img.astype(np.float64)
    v = ((1 - wy) * ((1 - wx) * f[y0][:, x0] + wx * f[y0][:, x1])
         + wy * ((1 - wx) * f[y1][:, x0] + wx * f[y1][:, x1]))
    np.testing.assert_array_equal(got, (v + 0.5).astype(np.uint8))
    assert np.abs(got.astype(int) - jnative.resize_bilinear(img, *dst).astype(int)).max() <= 1


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The decoder's library unbuilt, in an empty build directory."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    build.load_host.cache_clear()
    _native._lib.cache_clear()
    yield tmp_path
    build.load_host.cache_clear()
    _native._lib.cache_clear()


def test_decoder_builds_at_first_use(fresh_build):
    assert not list(fresh_build.glob("build/*.so"))
    enc = np.array([[3, 5]], np.int64)
    np.testing.assert_array_equal(_native.rle_decode(enc, 4096)[:10],
                                  [0, 0, 0, 1, 1, 1, 1, 1, 0, 0])
    assert [p.name for p in fresh_build.glob("build/*.so")] == [
        build.host_library_path("data_ops").name]


def test_failed_build_raises(fresh_build, monkeypatch):
    """A source g++ refuses, or no g++: the decode raises with the reason,
    and ``mask_decode`` does not fall back to numpy."""
    csrc = fresh_build / "csrc"
    csrc.mkdir()
    (csrc / "data_ops.cpp").write_text('extern "C" void rle_decode( {\n')
    monkeypatch.setattr(build, "CSRC", csrc)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for data_ops.cpp"):
        pie_bench.mask_decode([0, 10], (512, 512))
    assert not _native.available()
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _native.rle_decode(np.array([[0, 1]]), 4096)
