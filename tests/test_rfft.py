"""R2C/C2R transforms vs numpy (config-4 capability extension)."""
import numpy as np
import pytest

import tensorfft_tpu as tfft
from tensorfft_tpu.rfft import irfft_split, rfft_split


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_rfft_matches_numpy(n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    plan = tfft.create_plan(n // 2, precision="float32", strategy="staged")
    o_re, o_im = rfft_split(x, plan)
    want = np.fft.rfft(x) / n  # library forward scaling
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    assert got.shape == (n // 2 + 1,)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_rfft_batched():
    n, b = 512, 6
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, n)).astype(np.float32)
    plan = tfft.create_plan(n // 2, precision="float32", strategy="staged")
    o_re, o_im = rfft_split(x, plan)
    want = np.fft.rfft(x, axis=-1) / n
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("scaling", ["forward", "none", "ortho"])
def test_rfft_irfft_roundtrip(scaling):
    n = 2048
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n).astype(np.float32)
    plan = tfft.create_plan(n // 2, precision="float32", strategy="staged",
                            scaling=scaling)
    o_re, o_im = rfft_split(x, plan)
    back = np.asarray(irfft_split(o_re, o_im, plan), np.float64)
    np.testing.assert_allclose(back, x, atol=2e-4)


def test_irfft_matches_numpy():
    n = 1024
    rng = np.random.default_rng(3)
    spec = np.fft.rfft(rng.standard_normal(n)) / n
    plan = tfft.create_plan(n // 2, precision="float32", strategy="staged")
    got = np.asarray(irfft_split(spec.real.copy(), spec.imag.copy(), plan), np.float64)
    want = np.fft.irfft(spec * n, n=n)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_rfft_rejects_odd_length():
    with pytest.raises(ValueError):
        rfft_split(np.ones(255))


def test_rfft_large_roundtrip_split_precision():
    # Config-4 scale: N = 2^20 roundtrip at the gate tolerances via the
    # x3-compensated float32 policy.
    n = 1 << 20
    rng = np.random.default_rng(4)
    x = rng.standard_normal(n).astype(np.float32)
    plan = tfft.create_plan(n // 2, precision="float32")
    o_re, o_im = rfft_split(x, plan)
    want = np.fft.rfft(x) / n
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    dev = np.abs(got - want)
    assert dev.mean() < 1e-3 and dev.max() < 0.5
    back = np.asarray(irfft_split(o_re, o_im, plan), np.float64)
    rt = np.abs(back - x)
    assert rt.mean() < 1e-3, rt.mean()


def test_rfftn_matches_numpy():
    # N-D R2C: rfft along the last axis + C2C along the rest, the
    # numpy.fft.rfftn contract (scaled by 1/prod(shape) under 'forward').
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    got = tfft.rfftn(x, precision="float32")
    want = np.fft.rfftn(x) / x.size
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-4
    back = tfft.irfftn(got, precision="float32")
    assert np.abs(back - x).max() < 1e-3


def test_rfftn_requires_last_axis():
    x = np.ones((4, 8), np.float32)
    with pytest.raises(ValueError, match="last axis"):
        tfft.rfftn_split(x, axes=(0,))


def test_rfftn_partial_axes():
    # axes=(-1,): pure rfft; axes=(0, 2): transform two of three dims.
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4, 6, 8)).astype(np.float32)
    got = tfft.rfftn(x, axes=(0, 2), precision="float32")
    want = np.fft.rfftn(x, axes=(0, 2)) / (4 * 8)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-4


# -- the pack / untangle epilogue (plain XLA) -----------------------------------

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402

rfft_mod = importlib.import_module("tensorfft_tpu.rfft")


def _untangle_fwd64(z, n, scale):
    """fp64 reference of rfft._untangle_fwd: X[k] = ((U+V) - i w (U-V)) s,
    U = Z[k], V = conj(Z[(M-k) mod M]), w = exp(-2 pi i k / N), k = 0..M."""
    m = n // 2
    k = np.arange(m + 1)
    u = z[..., k % m]
    v = np.conj(z[..., (m - k) % m])
    w = np.exp(-2j * np.pi * k / n)
    return ((u + v) - 1j * w * (u - v)) * scale


def _retangle_inv64(x, n, scale):
    """fp64 reference of rfft._retangle_inv: Z[k] = (A + i w B) s with
    A = X[k] + conj(X[M-k]), B = X[k] - conj(X[M-k]), w = exp(+2 pi i k/N)."""
    m = n // 2
    k = np.arange(m)
    a = x[..., k] + np.conj(x[..., m - k])
    b = x[..., k] - np.conj(x[..., m - k])
    return (a + 1j * np.exp(2j * np.pi * k / n) * b) * scale


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,m", [(16, 512), (4, 2048), (5, 256), (1, 1024)])
def test_pack_matches_deinterleave(b, m, dtype):
    # The even/odd pack is an exact permutation in the storage dtype.
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((b, 2 * m)), jnp.dtype(dtype))
    got_re, got_im = rfft_mod._deinterleave(x)
    assert got_re.dtype == x.dtype and got_re.shape == (b, m)
    xs = np.asarray(x, np.float32)
    np.testing.assert_array_equal(np.asarray(got_re, np.float32), xs[:, 0::2])
    np.testing.assert_array_equal(np.asarray(got_im, np.float32), xs[:, 1::2])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,m", [(16, 512), (3, 2048)])
def test_interleave_matches_stack(b, m, dtype):
    rng = np.random.default_rng(1)
    dt = jnp.dtype(dtype)
    re = jnp.asarray(rng.standard_normal((b, m)), dt)
    im = jnp.asarray(rng.standard_normal((b, m)), dt)
    got = rfft_mod._interleave(re, im).astype(dt)
    assert got.shape == (b, 2 * m)
    want = np.empty((b, 2 * m), np.float32)
    want[:, 0::2] = np.asarray(re, np.float32)
    want[:, 1::2] = np.asarray(im, np.float32)
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,m", [(16, 512), (2, 2048), (7, 128)])
def test_untangle_matches_fp64(b, m, dtype):
    rng = np.random.default_rng(2)
    dt = jnp.dtype(dtype)
    n = 2 * m
    z_re = jnp.asarray(rng.standard_normal((b, m)), dt)
    z_im = jnp.asarray(rng.standard_normal((b, m)), dt)
    got_re, got_im = rfft_mod._untangle_fwd(z_re, z_im, n, 0.25, dt)
    assert got_re.shape == (b, m + 1) and got_re.dtype == dt
    z = np.asarray(z_re, np.float64) + 1j * np.asarray(z_im, np.float64)
    want = _untangle_fwd64(z, n, 0.25)
    # f32 arithmetic, then one rounding to the storage dtype.
    tol = 1e-2 if dtype == "bfloat16" else 2e-6
    np.testing.assert_allclose(np.asarray(got_re, np.float64), want.real,
                               atol=tol)
    np.testing.assert_allclose(np.asarray(got_im, np.float64), want.imag,
                               atol=tol)
    # The Nyquist bin is exactly real.
    assert np.all(np.asarray(got_im)[:, m] == 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,m", [(16, 512), (2, 2048), (7, 128)])
def test_retangle_matches_fp64(b, m, dtype):
    rng = np.random.default_rng(3)
    dt = jnp.dtype(dtype)
    n = 2 * m
    re = jnp.asarray(rng.standard_normal((b, m + 1)), dt)
    im = jnp.asarray(rng.standard_normal((b, m + 1)), dt)
    got_re, got_im = rfft_mod._retangle_inv(
        re.astype(jnp.float32), im.astype(jnp.float32), n, 1.0)
    assert got_re.shape == (b, m)
    x = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    want = _retangle_inv64(x, n, 1.0)
    np.testing.assert_allclose(np.asarray(got_re, np.float64), want.real,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(got_im, np.float64), want.imag,
                               atol=2e-5)


@pytest.mark.parametrize("strategy", ["staged", "xla"])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_rfft_roundtrip_both_routes(precision, strategy):
    n, b = 4096, 4
    rng = np.random.default_rng(4)
    plan = tfft.create_plan(n // 2, precision=precision, strategy=strategy)
    st = plan.precision.storage_dtype
    x = jnp.asarray(rng.standard_normal((b, n)), st)
    o_re, o_im = rfft_split(x, plan)
    assert o_re.dtype == st and o_re.shape == (b, n // 2 + 1)
    want = np.fft.rfft(np.asarray(x, np.float64), axis=-1) / n
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    tol = 2e-3 if precision == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, atol=tol)
    back = irfft_split(o_re, o_im, plan)
    assert back.dtype == st and back.shape == (b, n)
    rt_tol = 3e-2 if precision == "bfloat16" else 2e-4
    np.testing.assert_allclose(np.asarray(back, np.float64),
                               np.asarray(x, np.float64), atol=rt_tol)


@pytest.mark.parametrize("shape", [(2048,), (3, 2048)])
def test_rfft_1d_and_odd_batch(shape):
    n = shape[-1]
    rng = np.random.default_rng(5)
    plan = tfft.create_plan(n // 2, precision="float32", strategy="staged")
    x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    p_re, p_im = rfft_split(x, plan)
    want = np.fft.rfft(np.asarray(x, np.float64), axis=-1) / n
    got = np.asarray(p_re, np.float64) + 1j * np.asarray(p_im, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_rfft_mid_length_roundtrip(precision):
    # Half length 2^15 at batch 2 (the former two-pass range).
    m, b = 1 << 15, 2
    n = 2 * m
    plan = tfft.create_plan(m, precision=precision)
    rng = np.random.default_rng(7)
    x64 = rng.standard_normal((b, n))
    x = jnp.asarray(x64, plan.precision.storage_dtype)
    f_re, f_im = rfft_split(x, plan)
    want = np.fft.rfft(np.asarray(x, np.float64), axis=-1) / n
    got = np.asarray(f_re, np.float64) + 1j * np.asarray(f_im, np.float64)
    tol = 2e-3 if precision == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, atol=tol)
    back = irfft_split(f_re, f_im, plan)
    # Storage rounds the spectrum and the output once each: 2^-8 (bf16) or
    # the bf16x3 stage error (float32), relative to |x| <= ~5.
    rt_tol = 6e-2 if precision == "bfloat16" else 5e-4
    np.testing.assert_allclose(np.asarray(back, np.float64),
                               np.asarray(x, np.float64), atol=rt_tol)


def test_rfft_plan_length_mismatch():
    with pytest.raises(ValueError, match="fft_length"):
        rfft_split(np.ones(256, np.float32), tfft.create_plan(256))
    with pytest.raises(ValueError, match="fft_length"):
        irfft_split(np.ones(129), np.zeros(129), tfft.create_plan(256))
    with pytest.raises(ValueError, match="irfft expects"):
        irfft_split(np.ones(129), np.zeros(129), n=300)
