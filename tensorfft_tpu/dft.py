"""DFT-matrix and twiddle-table construction.

Replacement for the reference's on-the-fly twiddle computation and
DFT-matrix literals: the reference builds its 16x16 DFT matrix per warp with
fp32 ``cosf``/``sinf`` rounded to fp16 (TensorRadix16.cu:113-125) or loads
fp16-exact literals (DFTMatrix.h:7-186), and computes per-element twiddles with
transcendentals in the hot loop (TensorRadix16.cu:104-145).

Here every table is precomputed in float64 on the host, rounded once to the
compute dtype (fp32), and passed to the jitted stages as constants.  Tables
are cached per (kind, shape, dtype, sign).

If the native helper library is built (tensorfft_tpu/native), large tables are
generated by multithreaded C++; otherwise NumPy vectorized code is used.  Both
produce bit-identical float64 results (tests/test_native.py).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

__all__ = [
    "dft_matrix",
    "stage_twiddle",
    "FORWARD",
    "INVERSE",
]

FORWARD = -1  # exp(-2*pi*i ...), the reference's forward convention
INVERSE = +1


def _native_tables():
    try:
        from tensorfft_tpu.native import lib as _lib  # noqa

        return _lib
    except Exception:
        return None


@functools.lru_cache(maxsize=None)
def _dft_matrix_f64(radix: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of D[t, r] = exp(sign * 2*pi*i * t * r / radix), float64."""
    native = _native_tables()
    if native is not None:
        return native.dft_matrix(radix, sign)
    t = np.arange(radix, dtype=np.int64)
    # Reduce t*r mod radix before the divide (mirrors the native generator's
    # expression order exactly): large angles lose low-order phase bits, and
    # matching the order keeps NumPy and C++ tables in lockstep.
    m = np.outer(t, t) % radix
    phase = sign * 2.0 * np.pi * m.astype(np.float64) / radix
    return np.cos(phase), np.sin(phase)


@functools.lru_cache(maxsize=None)
def _stage_twiddle_f64(
    radix: int, prior_length: int, sign: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of W[r, k] = exp(sign * 2*pi*i * r * k / (radix*prior_length)).

    Shape (radix, prior_length): the twiddle applied to sub-FFT bin k of
    time-shift r when combining ``radix`` sub-FFTs of length ``prior_length``
    (the reference computes exactly this per element at
    TensorRadix16.cu:104-145).
    """
    native = _native_tables()
    if native is not None:
        return native.stage_twiddle(radix, prior_length, sign)
    r = np.arange(radix, dtype=np.int64)[:, None]
    k = np.arange(prior_length, dtype=np.int64)[None, :]
    denom = radix * prior_length
    # Same modular reduction + expression order as the native generator.
    m = (r * k) % denom
    phase = sign * 2.0 * np.pi * m.astype(np.float64) / denom
    return np.cos(phase), np.sin(phase)


def dft_matrix(radix: int, dtype=np.float32, sign: int = FORWARD, scale: float = 1.0):
    """DFT matrix (re, im) as ``dtype`` arrays, optionally pre-scaled.

    Folding the progressive per-stage 1/radix scale into the matrix makes the
    reference's "sequential scaling" (TensorFFT256.cu:167-171) free.
    """
    re, im = _dft_matrix_f64(radix, sign)
    if scale != 1.0:
        re = re * scale
        im = im * scale
    return np.asarray(re, dtype=dtype), np.asarray(im, dtype=dtype)


def stage_twiddle(radix: int, prior_length: int, dtype=np.float32, sign: int = FORWARD):
    """Stage twiddle table (re, im) of shape (radix, prior_length) as ``dtype``."""
    re, im = _stage_twiddle_f64(radix, prior_length, sign)
    return np.asarray(re, dtype=dtype), np.asarray(im, dtype=dtype)
