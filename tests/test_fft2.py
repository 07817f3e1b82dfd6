"""2D / N-D transforms by row-column decomposition over the 1D routes."""
import numpy as np
import pytest

import tensorfft_tpu as tfft


def _check2d(shape, precision="float32", atol=5e-6):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    o = tfft.fftn_split(x, y, axes=(-2, -1), precision=precision)
    want = np.fft.fft2(x + 1j * y) / (shape[-2] * shape[-1])
    got = np.asarray(o[0], np.float64) + 1j * np.asarray(o[1], np.float64)
    assert np.abs(got - want).max() < atol, np.abs(got - want).max()


@pytest.mark.parametrize("shape", [(64, 128), (256, 256), (3, 64, 256), (2, 2, 32, 64)])
def test_fft2_shapes(shape):
    _check2d(shape)


def test_fft2_nonsquare_and_odd_heights():
    _check2d((8, 512))
    _check2d((512, 8))


def test_fft2_inverse_roundtrip():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    y = rng.standard_normal((64, 128)).astype(np.float32)
    f = tfft.fftn_split(x, y, axes=(-2, -1), precision="float32")
    b = tfft.ifftn_split(f[0], f[1], axes=(-2, -1), precision="float32")
    np.testing.assert_allclose(np.asarray(b[0]), x, atol=2e-4)
    np.testing.assert_allclose(np.asarray(b[1]), y, atol=2e-4)


def test_fftn_3d_peel():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 32, 64)).astype(np.float32)
    y = rng.standard_normal((16, 32, 64)).astype(np.float32)
    o = tfft.fftn_split(x, y, precision="float32")
    want = np.fft.fftn(x + 1j * y) / x.size
    got = np.asarray(o[0], np.float64) + 1j * np.asarray(o[1], np.float64)
    assert np.abs(got - want).max() < 1e-5


def test_fft2_non_power_of_two_falls_back():
    # 48 is not a power of two: generic per-axis loop must still work... it
    # requires power-of-2 lengths, so expect a clean error instead.
    with pytest.raises(ValueError):
        tfft.fftn_split(np.ones((48, 64)), np.ones((48, 64)), axes=(-2, -1))