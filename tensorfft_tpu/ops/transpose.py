"""Digit-reversal reordering as XLA reshapes/transposes.

Reference parity for the standalone TransposeKernel (Transposer.cu:65-93) and
the fused gather inside the base kernels (TensorFFT256.cu:99-178): here the
mixed-radix digit reversal is exactly a multi-axis tensor transpose, so no
kernel is needed — the Stockham formulation in the stage engines avoids the
reorder entirely, and this module exists as the testable reference and for
algorithms (e.g. DIF variants) that want an explicit reorder.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["digit_reversal_permutation", "digit_reverse", "digit_reverse_jax"]


def digit_reversal_permutation(n: int, radices: Sequence[int]) -> np.ndarray:
    """perm[j] = source index feeding output slot j (Transposer.cu:25-35 math).

    Digits of j are taken in combine order (first radix = least significant)
    and re-assembled most-significant-first.  Uses the native library when
    built.
    """
    if int(np.prod(radices)) != n:
        raise ValueError(f"radices {radices} do not factor {n}")
    try:
        from tensorfft_tpu.native import lib as _native

        if _native is not None:
            return _native.digit_reversal_perm(n, list(radices))
    except Exception:
        pass
    perm = np.empty(n, dtype=np.int64)
    for j in range(n):
        rem, src = j, 0
        for r in radices:
            src = src * r + rem % r
            rem //= r
        perm[j] = src
    return perm


def digit_reverse(x: np.ndarray, radices: Sequence[int], axis: int = -1):
    """Apply the digit reversal along ``axis`` via reshape + transpose.

    Equivalent to gathering with :func:`digit_reversal_permutation` but
    expressed as the tensor transpose XLA fuses for free: view the axis as
    (r_s, ..., r_1), reverse the sub-axes, flatten.
    """
    x = np.asarray(x)
    axis = axis % x.ndim
    n = x.shape[axis]
    if int(np.prod(radices)) != n:
        raise ValueError(f"radices {radices} do not factor {n}")
    lead = x.shape[:axis]
    tail = x.shape[axis + 1:]
    rev = tuple(reversed(radices))
    x = x.reshape(*lead, *rev, *tail)
    k = len(radices)
    perm = (
        tuple(range(len(lead)))
        + tuple(len(lead) + k - 1 - i for i in range(k))
        + tuple(len(lead) + k + i for i in range(len(tail)))
    )
    x = x.transpose(perm)
    return x.reshape(*lead, n, *tail)


def digit_reverse_jax(x, radices: Sequence[int], axis: int = -1):
    """JAX version of :func:`digit_reverse` (same reshape/transpose dance)."""
    import jax.numpy as jnp

    x = jnp.asarray(x)
    axis = axis % x.ndim
    n = x.shape[axis]
    if int(np.prod(radices)) != n:
        raise ValueError(f"radices {radices} do not factor {n}")
    lead = x.shape[:axis]
    tail = x.shape[axis + 1:]
    rev = tuple(reversed(radices))
    x = x.reshape(*lead, *rev, *tail)
    k = len(radices)
    perm = (
        tuple(range(len(lead)))
        + tuple(len(lead) + k - 1 - i for i in range(k))
        + tuple(len(lead) + k + i for i in range(len(tail)))
    )
    x = jnp.transpose(x, perm)
    return x.reshape(*lead, n, *tail)
