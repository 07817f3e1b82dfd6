"""Tests for the conformance harness itself (datagen/oracle/metrics/timer)."""
import numpy as np

from tensorfft_tpu.testing import (
    Deviation,
    deviation,
    fft_oracle,
    get_random_weights,
    make_test_signal,
    measure,
    sine_superposition,
)


def test_weights_deterministic_and_bounded():
    a = get_random_weights(20, 42)
    b = get_random_weights(20, 42)
    c = get_random_weights(20, 43)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (20,)
    assert np.all(np.abs(a) <= 1.0)


def test_sine_superposition_single_harmonic():
    n = 256
    x = sine_superposition(n, np.array([0.0, 1.0]))  # pure sin(2*pi*n/N)
    expected = np.sin(2 * np.pi * np.arange(n) / n)
    np.testing.assert_allclose(x, expected, atol=1e-12)


def test_sine_superposition_chunking_consistent():
    # Force the chunked path to agree with a direct computation.
    n = 1 << 12
    w = get_random_weights(20, 7)
    x = sine_superposition(n, w)
    direct = sum(
        w[h] * np.sin(2 * np.pi * h * np.arange(n) / n) for h in range(20)
    )
    np.testing.assert_allclose(x, direct, atol=1e-10)


def test_oracle_peaks_at_harmonics():
    # FFT of sum w_h sin(2*pi*h*j/N), 1/N-scaled: bin h = -i*w_h/2, bin N-h = +i*w_h/2.
    n = 1024
    w = np.zeros(8)
    w[3] = 2.0
    re = sine_superposition(n, w)
    im = np.zeros(n)
    o_re, o_im = fft_oracle(re, im)
    assert abs(o_im[3] - (-1.0)) < 1e-12
    assert abs(o_im[n - 3] - 1.0) < 1e-12
    assert np.abs(o_re).max() < 1e-12


def test_deviation_metrics():
    got = (np.array([1.0, 2.0]), np.array([3.0, 4.0]))
    want = (np.array([1.0, 2.1]), np.array([3.0, 4.0]))
    d = deviation(got, want)
    assert abs(d.maximum - 0.1) < 1e-12
    assert abs(d.average - 0.025) < 1e-12
    assert not d.passes_reference_gate()  # avg 0.025 > 1e-3
    good = (np.array([1.0, 2.0999]), np.array([3.0, 4.0]))
    assert deviation(good, want).passes_reference_gate()


def test_deviation_gate_thresholds():
    d = Deviation(average=1e-3, sigma=1e-2, maximum=0.5)
    assert d.passes_reference_gate()
    assert not Deviation(2e-3, 1e-3, 0.1).passes_reference_gate()


def test_measure_runs():
    import jax.numpy as jnp

    r = measure(lambda x: x + 1, args=(jnp.ones(8),), warmup=1, samples=3)
    assert r.average_time_ns > 0
    assert r.samples == 3


def test_batch_file_roundtrip_and_many_vs_one(tmp_path):
    # Per-batch-element dumps + many-vs-one file comparison
    # (FileWriter.h:78-169 / AccuracyCalculator.h:349-658 analogs).
    from tensorfft_tpu.testing.io import (
        compare_many_result_files,
        compare_result_files,
        read_result_batch_from_files,
        write_result_batch_to_files,
        write_results_to_file,
    )

    rng = np.random.default_rng(0)
    re = rng.standard_normal((3, 64))
    im = rng.standard_normal((3, 64))
    paths = write_result_batch_to_files(tmp_path / "batch", re, im)
    assert len(paths) == 3
    r2, i2 = read_result_batch_from_files(paths)
    np.testing.assert_allclose(r2, re, rtol=1e-15)
    np.testing.assert_allclose(i2, im, rtol=1e-15)

    ref_path = tmp_path / "oracle.dat"
    write_results_to_file(ref_path, re[1], im[1])
    devs = compare_many_result_files(paths, ref_path)
    assert devs[1].maximum == 0.0
    assert devs[0].maximum > 0.0

    d = compare_result_files(paths[2], ref_path)
    assert d.maximum == devs[2].maximum

    # Length mismatch is a typed error.
    import pytest

    short = tmp_path / "short.dat"
    write_results_to_file(short, re[0, :32], im[0, :32])
    with pytest.raises(ValueError):
        compare_result_files(paths[0], short)


# -- matrix-product precision audit (testing.precision) ------------------------

def test_precision_audit_flags_default_f32_dot():
    import jax.numpy as jnp

    from tensorfft_tpu.testing.precision import default_precision_f32_dots

    a = jnp.ones((8, 8), jnp.float32)
    assert len(default_precision_f32_dots(lambda x: x @ x, a)) == 1
    assert not default_precision_f32_dots(
        lambda x: jnp.dot(x, x, precision="highest"), a)
    bf = lambda x: jnp.dot(x.astype(jnp.bfloat16), x.astype(jnp.bfloat16))
    assert not default_precision_f32_dots(bf, a)


def test_precision_audit_sees_inside_jit():
    import jax
    import jax.numpy as jnp

    from tensorfft_tpu.testing.precision import default_precision_f32_dots

    a = jnp.ones((8, 8), jnp.float32)
    inner = jax.jit(lambda x: x @ x)
    assert len(default_precision_f32_dots(lambda x: inner(x) + 1, a)) == 1


import pytest  # noqa: E402


@pytest.mark.parametrize("precision", ["bfloat16", "float32", "float32_x6",
                                       "float64"])
def test_staged_stage_products_never_tf32(precision):
    # Every stage product takes bf16 operands or HIGHEST precision.
    import jax.numpy as jnp

    import tensorfft_tpu as tfft
    from tensorfft_tpu.testing.precision import default_precision_f32_dots

    plan = tfft.create_plan(1024, precision=precision, strategy="staged")
    x = jnp.ones((4, 1024), plan.precision.storage_dtype)
    step = lambda a, b: tfft.fft_split(a, b, plan)
    assert not default_precision_f32_dots(step, x, x)
