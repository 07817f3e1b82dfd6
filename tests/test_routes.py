"""Both execution routes (staged stage loop, xla/jnp.fft) vs the fp64 oracle.

The cases follow the transform cases the library serves: lengths, batch
shapes, radix mixes, storage dtypes, scaling conventions, both directions,
and the typed errors of the public entry points.  On the GPU the staged route
runs the same stage products with bf16 operands or HIGHEST precision, and
the xla route is cuFFT.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import tensorfft_tpu as tfft
from tensorfft_tpu.fft import transform_major
from tensorfft_tpu.testing import deviation, fft_oracle, make_test_signal

ROUTES = ["staged", "xla"]


def run(n, b, strategy, precision="bfloat16", radices=None, seed=0,
        forward=True, scaling="forward", dtype=np.float32):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((b, n)).astype(dtype)
    im = rng.standard_normal((b, n)).astype(dtype)
    plan = tfft.create_plan(n, precision=precision, strategy=strategy,
                            radices=radices, scaling=scaling)
    fn = tfft.fft_split if forward else tfft.ifft_split
    o_re, o_im = fn(re, im, plan)
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    norm = {"forward": "forward", "none": "backward", "ortho": "ortho"}[scaling]
    want = (np.fft.fft if forward else np.fft.ifft)(x, axis=-1, norm=norm)
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max(), np.abs(want).max()


@pytest.mark.parametrize("strategy", ROUTES)
@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_route_matches_oracle(strategy, n):
    # bf16 storage and bf16 stage operands: ~1e-3 max err on dense input.
    err, _ = run(n, 128, strategy)
    assert err < 5e-3


@pytest.mark.parametrize("strategy", ROUTES)
@pytest.mark.parametrize("n", [256, 4096])
def test_route_float32_policy(strategy, n):
    # bf16x3 split products (staged) / complex64 (xla): ~fp32-grade.
    err, _ = run(n, 128, strategy, precision="float32")
    assert err < 1e-5


@pytest.mark.parametrize("strategy", ROUTES)
@pytest.mark.parametrize("b", [1, 7, 130])
def test_route_batch_shapes(strategy, b):
    err, _ = run(512, b, strategy)
    assert err < 5e-3


@pytest.mark.parametrize("radices", [(16, 16), (2, 128), (4, 4, 16),
                                     (16, 16, 8), (256,)])
def test_staged_radix_mixes(radices):
    n = int(np.prod(radices))
    err, _ = run(n, 16, "staged", precision="float32", radices=radices)
    assert err < 1e-5


@pytest.mark.parametrize("strategy", ROUTES)
def test_route_bf16_storage(strategy):
    n, b = 1024, 64
    rng = np.random.default_rng(1)
    re = rng.standard_normal((b, n)).astype(np.float32)
    im = rng.standard_normal((b, n)).astype(np.float32)
    plan = tfft.create_plan(n, strategy=strategy)
    o_re, o_im = tfft.fft_split(jnp.asarray(re, jnp.bfloat16),
                                jnp.asarray(im, jnp.bfloat16), plan)
    assert o_re.dtype == jnp.bfloat16 and o_im.dtype == jnp.bfloat16
    want = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1) / n
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    # bf16 input quantization dominates
    assert np.abs(got - want).max() < 2e-2


@pytest.mark.parametrize("strategy", ROUTES)
@pytest.mark.parametrize("n", [16384, 65536])
def test_route_gate_at_large_n(strategy, n):
    # The reference test signal through the public API at the lengths that
    # used to split between one-pass and two-pass kernels.
    re, im = make_test_signal(n, 3, 4)
    plan = tfft.create_plan(n, precision="float32", strategy=strategy)
    got = tfft.fft_split(re, im, plan)
    d = deviation(
        (np.asarray(got[0], np.float64), np.asarray(got[1], np.float64)),
        fft_oracle(re, im),
    )
    assert d.passes_reference_gate() and d.average < 1e-5, f"N={n}: {d}"


@pytest.mark.parametrize("strategy", ROUTES)
@pytest.mark.parametrize("b,n", [(7, 512), (64, 1024)])
def test_route_batch_major_input(strategy, b, n):
    err, _ = run(n, b, strategy, precision="float32")
    assert err < 1e-5


@pytest.mark.parametrize("strategy", ROUTES)
def test_route_mid_n_small_batch(strategy):
    n, b = 32768, 2
    rng = np.random.default_rng(33)
    re = rng.standard_normal((b, n)).astype(np.float32)
    im = rng.standard_normal((b, n)).astype(np.float32)
    plan = tfft.create_plan(n, precision="bfloat16", strategy=strategy)
    o_re, o_im = tfft.fft_split(re, im, plan)
    want = np.fft.fft(re + 1j * im, axis=-1) / n
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    err = np.abs(got - want)
    assert err.mean() < 1e-3 and err.max() < 0.5


@pytest.mark.parametrize("strategy", ROUTES)
@pytest.mark.parametrize("scaling", ["forward", "none", "ortho"])
@pytest.mark.parametrize("forward", [True, False])
def test_route_scaling_and_direction(strategy, scaling, forward):
    # Library conventions are numpy's norm modes: forward / backward / ortho.
    err, scale = run(256, 4, strategy, precision="float32", scaling=scaling,
                     forward=forward)
    # bf16x3 stage products keep about 16 mantissa bits.
    assert err / scale < 1e-4


@pytest.mark.parametrize("strategy", ROUTES)
def test_route_float64_is_exact(strategy):
    # float64 plans run complex128 on the xla route (not complex64) and the
    # exact f64 stage products on the staged route.
    re, im = make_test_signal(4096, 5, 6)
    plan = tfft.create_plan(4096, precision="float64", strategy=strategy)
    o_re, o_im = tfft.fft_split(re, im, plan)
    assert o_re.dtype == jnp.float64
    want = fft_oracle(re, im)
    d = deviation((np.asarray(o_re), np.asarray(o_im)), want)
    assert d.maximum < 1e-12, str(d)


@pytest.mark.parametrize("strategy", ROUTES)
def test_transform_major_matches_fft_split(strategy):
    # The per-shard engine of the distributed paths: axis 0 of (N, B).
    n, b = 1024, 6
    rng = np.random.default_rng(9)
    re = rng.standard_normal((b, n)).astype(np.float32)
    im = rng.standard_normal((b, n)).astype(np.float32)
    plan = tfft.create_plan(n, precision="float32", strategy=strategy)
    t_re, t_im = transform_major(jnp.asarray(re.T), jnp.asarray(im.T), plan,
                                 True)
    s_re, s_im = tfft.fft_split(re, im, plan)
    np.testing.assert_allclose(np.asarray(t_re).T, np.asarray(s_re),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(t_im).T, np.asarray(s_im),
                               atol=1e-6)


def test_entry_typed_errors():
    # User-facing shape errors are ValueError, not bare assert (reference
    # parity: every fallible call returns an error, ComputeFFT.h:147-150).
    x = jnp.zeros((8, 64), jnp.float32)
    y = jnp.zeros((8, 32), jnp.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfft.fft_split(x, y)
    with pytest.raises(ValueError, match="plan is for fft_length"):
        tfft.fft_split(x, x, tfft.create_plan(128))
    with pytest.raises(ValueError, match="plan is for fft_length"):
        transform_major(x, x, tfft.create_plan(64), True)
    with pytest.raises(ValueError):
        tfft.fft_split(jnp.zeros((4, 48)), jnp.zeros((4, 48)))
