"""Stockham stage engine in plain JAX (the staged route).

A re-expression of the reference's kernel pipeline (ComputeFFT.h:54-151):
where the reference launches one base kernel (TensorFFT256.cu /
TensorFFT4096.cu) followed by ping-ponged TensorRadix16 and Radix2 launches,
here every Cooley-Tukey stage is one complex matmul over a transform-major
(N, B) layout, composed functionally and left to XLA to schedule.

Layout invariant (DIT Stockham, autosort — no digit-reversal pass needed,
unlike the reference's fused gather at TensorFFT256.cu:99-178):

  After j stages with K = prod(radices[:j]), the state A has shape
  (K, (N//K) * B): row k holds DFT_K bin k of every length-K decimated
  subsequence of the input; batch rides the innermost dimension.

Each stage, for radix R with M = N//(K*R):
  1. view (K, R, M*B), swap to (R, K, M*B)      [transpose]
  2. twiddle multiply by W[r, k] (skipped at stage 0 where K == 1)
  3. complex matmul by the (pre-scaled) R-point DFT matrix
  4. rows (t, k) merge into the new K = R*K     [free reshape]
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tensorfft_tpu import dft
from tensorfft_tpu.ops import dots

__all__ = ["apply_stages", "complex_matmul", "stage_tables"]


def stage_tables(
    radices: Sequence[int],
    scales: Sequence[float],
    sign: int,
    dtype=np.float32,
):
    """Precompute per-stage (D_re, D_im, D_sum, W_re, W_im) numpy tables.

    D_sum = D_re + D_im (computed in f64, rounded once) feeds the Karatsuba
    complex multiply.
    """
    tables = []
    k = 1
    for j, (r, s) in enumerate(zip(radices, scales)):
        d_re64, d_im64 = dft.dft_matrix(r, dtype=np.float64, sign=sign, scale=s)
        d_re = d_re64.astype(dtype)
        d_im = d_im64.astype(dtype)
        d_sum = (d_re64 + d_im64).astype(dtype)
        if j == 0:
            w_re = w_im = None
        else:
            w_re, w_im = dft.stage_twiddle(r, k, dtype=dtype, sign=sign)
        tables.append((d_re, d_im, d_sum, w_re, w_im))
        k *= r
    return tables


def complex_matmul(
    d_re, d_im, d_sum, z_re, z_im, *, algorithm: str = "bf16",
    karatsuba: bool = False,
):
    """(d_re + i*d_im) @ (z_re + i*z_im) with fp32 accumulation.

    Karatsuba (3 real matmuls instead of 4) trades one product for three
    elementwise adds — a win whenever the products bound the stage.
    d_sum = d_re+d_im is precomputed on the host in f64.
    """
    if karatsuba:
        m1 = dots.dot(d_sum, z_re, algorithm)
        m2 = dots.dot(d_re, z_im - z_re, algorithm)
        m3 = dots.dot(d_im, z_re + z_im, algorithm)
        return m1 - m3, m1 + m2
    re = dots.dot(d_re, z_re, algorithm) - dots.dot(d_im, z_im, algorithm)
    im = dots.dot(d_re, z_im, algorithm) + dots.dot(d_im, z_re, algorithm)
    return re, im


def apply_stages(
    re,
    im,
    radices: Sequence[int],
    scales: Sequence[float],
    sign: int = dft.FORWARD,
    *,
    algorithm: str = "bf16",
    karatsuba: bool = False,
    tables=None,
    return_intermediates: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Run the full stage sequence on transform-major (N, B) planes.

    ``re``/``im``: real arrays of shape (N, B); the transform runs along axis
    0, batch along axis 1.  Twiddle multiplies and inter-stage state are fp32
    (fp64 for algorithm='exact' with f64 inputs); matmul operands follow
    ``algorithm`` (see ops/dots.py).  Returns (re, im) of shape (N, B) with
    the (scaled) DFT bins in natural order.
    """
    n, b = re.shape
    compute_dtype = (
        jnp.float64
        if (algorithm == "exact" and re.dtype == jnp.float64)
        else jnp.float32
    )
    np_dtype = np.dtype("float64") if compute_dtype == jnp.float64 else np.dtype("float32")
    if tables is None:
        tables = stage_tables(radices, scales, sign, dtype=np_dtype)

    re = re.astype(compute_dtype)
    im = im.astype(compute_dtype)
    intermediates = []
    k = 1
    m = n
    for j, radix in enumerate(radices):
        m //= radix
        d_re, d_im, d_sum, w_re, w_im = tables[j]
        d_re, d_im, d_sum = jnp.asarray(d_re), jnp.asarray(d_im), jnp.asarray(d_sum)
        z_re = re.reshape(k, radix, m * b).swapaxes(0, 1)
        z_im = im.reshape(k, radix, m * b).swapaxes(0, 1)
        if j > 0:
            w_re = jnp.asarray(w_re)[:, :, None]
            w_im = jnp.asarray(w_im)[:, :, None]
            z_re, z_im = (
                z_re * w_re - z_im * w_im,
                z_re * w_im + z_im * w_re,
            )
        z_re = z_re.reshape(radix, k * m * b)
        z_im = z_im.reshape(radix, k * m * b)
        re, im = complex_matmul(
            d_re, d_im, d_sum, z_re, z_im,
            algorithm=algorithm, karatsuba=karatsuba,
        )
        k *= radix
        re = re.reshape(k, m * b)
        im = im.reshape(k, m * b)
        if return_intermediates:
            intermediates.append((re.reshape(n, b), im.reshape(n, b)))
    if return_intermediates:
        # Post-stage state dumps: the analog of the reference's debug kernel
        # TensorFFT4096_2 + IntermediateData.cu probe (inspect each stage's
        # output rather than only the end-to-end result).
        return intermediates
    return re.reshape(n, b), im.reshape(n, b)
