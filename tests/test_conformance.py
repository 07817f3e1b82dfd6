"""The reference unit-test gate (UnitTest.cu analog).

Default CI runs a reduced sweep (every power of two 256..2^16, 3 seeds) at
the exact reference thresholds on the half-precision policy; pass
``--full-conformance`` for the complete UnitTest.cu sweep (256..2^20, 10
seeds).  The device's stage numerics are reproduced exactly on the CPU by
the explicit bf16 operand decompositions (ops/dots.py).
"""
import pytest

from tensorfft_tpu.testing.conformance import (
    REFERENCE_SWEEP,
    run_unit_sweep,
    test_full_fft as check_full_fft,
)


def test_reduced_sweep_bfloat16():
    assert run_unit_sweep(
        start_fft_length=256,
        end_fft_length=1 << 16,
        runs_per_fft_length=3,
        precision="bfloat16",
        verbose=False,
    )


def test_reference_thresholds_are_defaults():
    ok, d = check_full_fft(256, precision="bfloat16")
    assert ok, str(d)


def test_full_reference_sweep(full_conformance):
    if not full_conformance:
        pytest.skip("pass --full-conformance for the complete UnitTest sweep")
    assert run_unit_sweep(**REFERENCE_SWEEP, precision="bfloat16")


def test_digit_reversal_reference():
    import numpy as np

    from tensorfft_tpu.ops.transpose import (
        digit_reversal_permutation,
        digit_reverse,
        digit_reverse_jax,
    )

    n, radices = 4096, (16, 16, 16)
    perm = digit_reversal_permutation(n, radices)
    x = np.random.default_rng(0).standard_normal(n)
    got = digit_reverse(x, radices)
    np.testing.assert_array_equal(got, x[perm])
    np.testing.assert_allclose(np.asarray(digit_reverse_jax(x, radices)), x[perm])

    # Defining property: gather by the permutation, then natural-order
    # Cooley-Tukey DIT equals the FFT.  Cheap check: reversal is a bijection
    # and reversing twice with reversed radices is the identity.
    back = digit_reverse(got, tuple(reversed(radices)))
    np.testing.assert_array_equal(back, x)
