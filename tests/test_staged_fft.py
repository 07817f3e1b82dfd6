"""The known-good plain-JAX path (Strategy.STAGED) vs the fp64 oracle.

This is the M1 milestone test: the reference-semantics FFT (progressive 1/N
scaling, split planar layout) implemented as Stockham matmul stages, verified
at the reference unit-test thresholds (UnitTest.cu:14-16) and far tighter in
float64.
"""
import numpy as np
import pytest

import tensorfft_tpu as tfft
from tensorfft_tpu.testing import deviation, fft_oracle, make_test_signal


def run_case(n, precision, radices=None, seeds=(0,)):
    plan = tfft.create_plan(
        n, precision=precision, strategy="staged", radices=radices
    )
    worst = None
    for s in seeds:
        re, im = make_test_signal(n, 42 * s, 42 * 42 * s)
        got = tfft.fft_split(re, im, plan)
        want = fft_oracle(re, im)
        d = deviation((np.asarray(got[0]), np.asarray(got[1])), want)
        if worst is None or d.average > worst.average:
            worst = d
    return worst


@pytest.mark.parametrize("n", [256, 512, 1024, 4096, 16384, 1 << 17])
def test_float64_is_machine_precision(n):
    d = run_case(n, "float64")
    assert d.maximum < 1e-12, str(d)


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192, 16384, 1 << 20])
def test_float32_passes_reference_gate(n):
    d = run_case(n, "float32", seeds=(0, 1, 2))
    assert d.passes_reference_gate(), f"N={n}: {d}"
    # f32 should beat the fp16-era gate by a wide margin.
    assert d.average < 1e-5, f"N={n}: {d}"


@pytest.mark.parametrize(
    "radices",
    [(16, 16, 16), (64, 64), (128, 32), (2, 2048), (4, 8, 128), (256, 16)],
)
def test_radix_mixes_agree(radices):
    d = run_case(4096, "float32", radices=radices)
    assert d.average < 1e-5, f"radices={radices}: {d}"


def test_batched_matches_single():
    n = 1024
    plan = tfft.create_plan(n, strategy="staged")
    rng = np.random.default_rng(3)
    re = rng.standard_normal((4, 3, n)).astype(np.float32)
    im = rng.standard_normal((4, 3, n)).astype(np.float32)
    bre, bim = tfft.fft_split(re, im, plan)
    for i in range(4):
        for j in range(3):
            sre, sim = tfft.fft_split(re[i, j], im[i, j], plan)
            np.testing.assert_allclose(np.asarray(bre)[i, j], np.asarray(sre), atol=1e-6)
            np.testing.assert_allclose(np.asarray(bim)[i, j], np.asarray(sim), atol=1e-6)


@pytest.mark.parametrize("precision,atol", [("float32", 2e-4), ("bfloat16", 1e-1)])
def test_ifft_roundtrip(precision, atol):
    n = 4096
    plan = tfft.create_plan(n, strategy="staged", precision=precision)
    rng = np.random.default_rng(5)
    re = rng.standard_normal(n).astype(np.float32)
    im = rng.standard_normal(n).astype(np.float32)
    fre, fim = tfft.fft_split(re, im, plan)
    rre, rim = tfft.ifft_split(fre, fim, plan)
    np.testing.assert_allclose(np.asarray(rre, np.float32), re, atol=atol)
    np.testing.assert_allclose(np.asarray(rim, np.float32), im, atol=atol)


def test_scaling_conventions():
    n = 512
    x = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    got_fwd = tfft.fft(
        x, tfft.create_plan(n, strategy="staged", scaling="forward", precision="float32")
    )
    got_none = tfft.fft(
        x, tfft.create_plan(n, strategy="staged", scaling="none", precision="float32")
    )
    want = np.fft.fft(x)
    np.testing.assert_allclose(np.asarray(got_fwd) * n, want, atol=1e-2)
    np.testing.assert_allclose(np.asarray(got_none), want, atol=1e-2)


def test_complex_convenience_api():
    n = 256
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    got = tfft.fft(x, strategy="staged", precision="float32")
    want = np.fft.fft(x) / n
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


def test_xla_strategy_baseline():
    n = 1024
    re, im = make_test_signal(n, 0, 1)
    plan = tfft.create_plan(n, strategy="xla", precision="float32")
    got = tfft.fft_split(re.astype(np.float32), im.astype(np.float32), plan)
    want = fft_oracle(re, im)
    d = deviation((np.asarray(got[0]), np.asarray(got[1])), want)
    assert d.average < 1e-6, str(d)


def test_bfloat16_policy_passes_gate():
    # The half-precision (reference-parity) policy: bf16 storage and bf16
    # stage operands.  Input quantization + per-stage operand rounding must
    # clear the reference fp16-era gate (margin ~3x at N=256, improving
    # with N).
    for n in (256, 4096, 65536):
        d = run_case(n, "bfloat16", seeds=(0, 1, 2))
        assert d.passes_reference_gate(), f"N={n}: {d}"


def test_precision_ladder():
    # Each compensation tier buys orders of magnitude: bf16 > x3 > x6 > f64.
    d_bf16 = run_case(4096, "bfloat16")
    d_x3 = run_case(4096, "float32")
    d_x6 = run_case(4096, "float32_x6")
    assert d_x3.average < d_bf16.average / 50, f"{d_x3} vs {d_bf16}"
    assert d_x6.average < d_x3.average / 10, f"{d_x6} vs {d_x3}"
