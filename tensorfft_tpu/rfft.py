"""Real-to-complex (R2C) and complex-to-real (C2R) transforms.

Capability extension beyond the reference (which is C2C-only) — BASELINE.md
config 4.  Standard half-length packing: a real signal of length N is packed
as a complex signal z[m] = x[2m] + i*x[2m+1] of length M = N/2, transformed
with the complex pipeline, and untangled elementwise:

    U[k] = Z[k],  V[k] = conj(Z[(M-k) mod M]),   k = 0..M
    X[k] = ((U+V) - i*w[k]*(U-V)) / 4            w[k] = exp(-2*pi*i*k/N)

(with our Z already carrying the 1/M forward scale, the /4 yields the
library's 1/N-scaled X).  The inverse reverses the untangling and runs the
complex pipeline backwards.  Everything is split planar; outputs have N/2+1
frequency bins (NumPy rfft convention).
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from tensorfft_tpu.fft import fft_split as _fft_split, ifft_split as _ifft_split
from tensorfft_tpu.plan import FFTPlan, create_plan

__all__ = ["rfft_split", "irfft_split", "rfft", "irfft",
           "rfftn_split", "irfftn_split", "rfftn", "irfftn"]


def _pack_tables(n: int, sign: int, bins: Optional[int] = None):
    m = n // 2
    k = np.arange(m + 1 if bins is None else bins, dtype=np.float64)
    phase = sign * 2.0 * np.pi * k / n
    return (
        jnp.asarray(np.cos(phase), jnp.float32),
        jnp.asarray(np.sin(phase), jnp.float32),
    )


def _reverse_mod(z):
    """z[..., (M-k) mod M] for k = 0..M-1 at aligned length M.

    roll(z, -1) puts z[(j+1) mod M] at j; reversing that yields
    z[(M-k) mod M] at k.  Both ops keep the full power-of-two length M — no
    gather and no odd-length (M+1) intermediates; the Nyquist bin is
    appended as a single (B, 1) column at the very end.
    """
    return jnp.flip(jnp.roll(z, -1, axis=-1), axis=-1)


def rfft_split(x, plan: Optional[FFTPlan] = None, **plan_kwargs):
    """Forward R2C FFT of a real array along the last axis.

    Returns (re, im) of shape (..., N/2 + 1), scaled by 1/N under the default
    'forward' convention (matching :func:`tensorfft_tpu.fft_split`).  The
    pack and untangle legs are plain XLA elementwise ops around the
    half-length complex transform.
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    if n % 2:
        raise ValueError(f"rfft length must be even, got {n}")
    m = n // 2
    if plan is None:
        plan = create_plan(m, **plan_kwargs)
    elif plan.fft_length != m:
        raise ValueError(f"plan must be for fft_length {m}, got {plan.fft_length}")

    z_re, z_im = _deinterleave(x)
    Z_re, Z_im = _fft_split(z_re, z_im, plan)
    return _untangle_fwd(Z_re, Z_im, n, _output_scale(plan, forward=True),
                         plan.precision.storage_dtype)


def _deinterleave(x):
    """(…, N) real -> even/odd planes (…, N/2) via a (…, M, 2) view."""
    m = x.shape[-1] // 2
    z = x.reshape(*x.shape[:-1], m, 2)
    return z[..., 0], z[..., 1]


def _untangle_fwd(Z_re, Z_im, n, scale, storage_dtype):
    """Half-length complex spectrum Z (…, M) -> R2C spectrum X (…, M+1).

    Bins 0..M-1 on aligned length-M arrays (see _reverse_mod); the Nyquist
    bin M is a closed form of Z[0] (w[M] = -1, U = Z[0], V = conj(Z[0]):
    X[M] = 2*(Re Z0 - Im Z0) * scale, imaginary part exactly 0).
    """
    m = n // 2
    Z_re = Z_re.astype(jnp.float32)
    Z_im = Z_im.astype(jnp.float32)
    u_re, u_im = Z_re, Z_im
    v_re = _reverse_mod(Z_re)
    v_im = -_reverse_mod(Z_im)

    w_re, w_im = _pack_tables(n, -1, bins=m)
    a_re, a_im = u_re + v_re, u_im + v_im          # U + V
    b_re, b_im = u_re - v_re, u_im - v_im          # U - V
    # -i * w * b  =  (-i)(w_re + i w_im)(b_re + i b_im)
    c_re = w_re * b_im + w_im * b_re
    c_im = -(w_re * b_re - w_im * b_im)
    out_re = (a_re + c_re) * scale
    out_im = (a_im + c_im) * scale
    nyq_re = 2.0 * scale * (Z_re[..., :1] - Z_im[..., :1])
    out_re = jnp.concatenate([out_re, nyq_re], axis=-1)
    out_im = jnp.concatenate([out_im, jnp.zeros_like(nyq_re)], axis=-1)
    return out_re.astype(storage_dtype), out_im.astype(storage_dtype)


def _output_scale(plan: FFTPlan, forward: bool) -> float:
    # Our half-length Z already carries the plan's scaling over length M; the
    # untangle contributes the remaining factor so the total matches the
    # convention over length N = 2M.
    if plan.scaling == "forward":
        return 0.25 if forward else 1.0
    if plan.scaling == "none":
        return 0.5 if forward else 0.5
    if plan.scaling == "ortho":
        # Z carries M^-1/2; total target (2M)^-1/2.
        return 0.5 / np.sqrt(2.0)
    raise ValueError(plan.scaling)


def irfft_split(re, im, plan: Optional[FFTPlan] = None, n: Optional[int] = None,
                **plan_kwargs):
    """Inverse of :func:`rfft_split`: (..., N/2+1) spectrum -> (..., N) real."""
    re = jnp.asarray(re)
    im = jnp.asarray(im)
    m = re.shape[-1] - 1
    n = 2 * m if n is None else n
    if n != 2 * m:
        raise ValueError(f"irfft expects n = 2*(bins-1) = {2*m}, got {n}")
    if plan is None:
        plan = create_plan(m, **plan_kwargs)
    elif plan.fft_length != m:
        raise ValueError(f"plan must be for fft_length {m}, got {plan.fft_length}")

    re = re.astype(jnp.float32)
    im = im.astype(jnp.float32)
    z_re, z_im = _retangle_inv(re, im, n, _inverse_pre_scale(plan))
    o_re, o_im = _ifft_split(z_re, z_im, plan)
    return _interleave(o_re, o_im).astype(plan.precision.storage_dtype)


def _retangle_inv(re, im, n, inv_scale):
    """R2C spectrum X (…, M+1) -> half-length complex spectrum Z (…, M).

    Rebuild Z[k], k = 0..M-1 from X: Z[k] = (A[k] + i*wi[k]*B[k]) where
    A = X[k] + conj(X[M-k]), B = X[k] - conj(X[M-k]), wi[k] = exp(+2pi i k/N).
    X index M-k for k = 0..M-1: reverse the whole (M+1)-bin array once and
    take the leading aligned length-M slice (flip(X)[k] = X[M-k]) — no
    gather; every elementwise op below runs on aligned length-M arrays.
    """
    m = n // 2
    x_re_k = re[..., :m]
    x_im_k = im[..., :m]
    x_re_r = jnp.flip(re, axis=-1)[..., :m]
    x_im_r = -jnp.flip(im, axis=-1)[..., :m]
    a_re, a_im = x_re_k + x_re_r, x_im_k + x_im_r
    b_re, b_im = x_re_k - x_re_r, x_im_k - x_im_r
    w_re, w_im = _pack_tables(n, +1, bins=m)
    # i * w * b
    c_re = -(w_re * b_im + w_im * b_re)
    c_im = w_re * b_re - w_im * b_im
    z_re = (a_re + c_re) * inv_scale
    z_im = (a_im + c_im) * inv_scale
    return z_re, z_im


def _interleave(re, im):
    """Even/odd planes (…, M) -> (…, 2M) real via a (…, M, 2) stack."""
    x = jnp.stack([re.astype(jnp.float32), im.astype(jnp.float32)], axis=-1)
    return x.reshape(*x.shape[:-2], 2 * x.shape[-2])


def _inverse_pre_scale(plan: FFTPlan) -> float:
    # Z[k] = A + i*w*B reconstructs the (1/M)-scaled Z exactly from the
    # (1/N)-scaled X ('forward'); other conventions rescale accordingly.
    if plan.scaling == "forward":
        return 1.0
    if plan.scaling == "none":
        return 0.5
    if plan.scaling == "ortho":
        return np.sqrt(0.5)
    raise ValueError(plan.scaling)


def rfftn_split(x, axes=None, **plan_kwargs):
    """N-dimensional R2C: rfft along the LAST axis, C2C along the others
    (numpy.fft.rfftn semantics on split planar output).

    Returns (re, im) of shape (..., n_last/2 + 1); scaling follows the
    library convention per axis (total 1/prod(shape[axes]) under 'forward').
    """
    from tensorfft_tpu.fft import fftn_split as _fftn_split

    x = jnp.asarray(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    if (x.ndim - 1) not in axes:
        raise ValueError("rfftn_split requires the last axis in axes")
    re, im = rfft_split(x, **plan_kwargs)
    rest = tuple(a for a in axes if a != x.ndim - 1)
    if rest:
        re, im = _fftn_split(re, im, axes=rest, **plan_kwargs)
    return re, im


def irfftn_split(re, im, axes=None, n: Optional[int] = None, **plan_kwargs):
    """Inverse of :func:`rfftn_split`: C2C inverse along the leading axes,
    C2R along the last."""
    from tensorfft_tpu.fft import ifftn_split as _ifftn_split

    re = jnp.asarray(re)
    im = jnp.asarray(im)
    if axes is None:
        axes = tuple(range(re.ndim))
    axes = tuple(a % re.ndim for a in axes)
    if (re.ndim - 1) not in axes:
        raise ValueError("irfftn_split requires the last axis in axes")
    rest = tuple(a for a in axes if a != re.ndim - 1)
    if rest:
        re, im = _ifftn_split(re, im, axes=rest, **plan_kwargs)
    return irfft_split(re, im, n=n, **plan_kwargs)


def rfftn(x, axes=None, **plan_kwargs):
    """Host-boundary N-D R2C convenience wrapper (returns NumPy complex64)."""
    o_re, o_im = rfftn_split(jnp.asarray(np.asarray(x)), axes, **plan_kwargs)
    return np.asarray(o_re, np.float32) + 1j * np.asarray(o_im, np.float32)


def irfftn(x, axes=None, n: Optional[int] = None, **plan_kwargs):
    x = np.asarray(x)
    return np.asarray(irfftn_split(x.real.copy(), x.imag.copy(), axes, n=n,
                                   **plan_kwargs))


def rfft(x, plan: Optional[FFTPlan] = None, **plan_kwargs):
    """Host-boundary convenience wrapper (returns NumPy complex64)."""
    o_re, o_im = rfft_split(jnp.asarray(np.asarray(x)), plan, **plan_kwargs)
    return np.asarray(o_re, np.float32) + 1j * np.asarray(o_im, np.float32)


def irfft(x, plan: Optional[FFTPlan] = None, n: Optional[int] = None,
          **plan_kwargs):
    x = np.asarray(x)
    return np.asarray(
        irfft_split(x.real.copy(), x.imag.copy(), plan, n=n, **plan_kwargs)
    )
