"""Spectral-analysis utilities: shifts, frequency grids, window functions.

Completeness layer for users coming from numpy.fft / scipy.signal: the
reference library ships no helpers (its drivers hand-compute bin indices,
e.g. the harmonic checks in src/testing/AccuracyCalculator.h:86-100), but a
production FFT framework needs the standard vocabulary around the transform.
Everything here is host-math-free-of-transcendentals-on-device: grids and
windows are built in fp64 NumPy and handed to the device as constants, the
shifts are pure `jnp.roll`s (XLA lowers them to two slices + a concat — no
gather).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax.numpy as jnp
import numpy as np

__all__ = [
    "fftshift", "ifftshift", "fftshift_split", "ifftshift_split",
    "fftfreq", "rfftfreq", "window",
]


def _norm_axes(x, axes):
    if axes is None:
        return tuple(range(x.ndim))
    if isinstance(axes, int):
        return (axes % x.ndim,)
    return tuple(a % x.ndim for a in axes)


def fftshift(x, axes=None):
    """Shift the zero-frequency bin to the center (numpy.fft.fftshift)."""
    x = jnp.asarray(x)
    for ax in _norm_axes(x, axes):
        x = jnp.roll(x, x.shape[ax] // 2, axis=ax)
    return x


def ifftshift(x, axes=None):
    """Inverse of :func:`fftshift` (exact also for odd lengths)."""
    x = jnp.asarray(x)
    for ax in _norm_axes(x, axes):
        x = jnp.roll(x, -(x.shape[ax] // 2), axis=ax)
    return x


def fftshift_split(re, im, axes=None):
    """fftshift on split planar (re, im) planes."""
    return fftshift(re, axes), fftshift(im, axes)


def ifftshift_split(re, im, axes=None):
    return ifftshift(re, axes), ifftshift(im, axes)


def fftfreq(n: int, d: float = 1.0, dtype=np.float32):
    """Frequency grid of an n-point C2C transform (numpy.fft.fftfreq)."""
    return jnp.asarray(np.fft.fftfreq(n, d), dtype)


def rfftfreq(n: int, d: float = 1.0, dtype=np.float32):
    """Frequency grid of the n-point R2C transform (numpy.fft.rfftfreq)."""
    return jnp.asarray(np.fft.rfftfreq(n, d), dtype)


_WINDOWS = {
    "rect": lambda n: np.ones(n),
    "hann": lambda n: np.hanning(n),
    "hamming": lambda n: np.hamming(n),
    "blackman": lambda n: np.blackman(n),
    "bartlett": lambda n: np.bartlett(n),
    "kaiser14": lambda n: np.kaiser(n, 14.0),
}


def window(kind: str, n: int, dtype=np.float32, periodic: bool = False):
    """Window function of length ``n`` (fp64-accurate, cast to ``dtype``).

    ``periodic=True`` returns the DFT-even variant (the n-point slice of the
    (n+1)-point symmetric window) — the right choice when the windowed frame
    feeds an FFT for spectral analysis; the default symmetric variant is the
    filter-design convention (matching numpy's window functions).
    """
    try:
        fn = _WINDOWS[kind]
    except KeyError:
        raise ValueError(
            f"unknown window {kind!r}; available: {sorted(_WINDOWS)}"
        ) from None
    w = fn(n + 1)[:n] if periodic else fn(n)
    return jnp.asarray(w, dtype)
