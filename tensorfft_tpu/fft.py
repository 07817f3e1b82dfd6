"""Public FFT execution layer.

Counterpart of the reference host dispatch ``ComputeFFT``
(/root/reference/src/base/ComputeFFT.h:54-151 single, :162-293 batched): where
the reference sequences kernel launches and ping-pongs device buffers through
a DataHandler (DataHandler.h:22-166), here execution is a pure jitted function
of the input arrays; batching is a leading axis (XLA overlaps what the
reference used one CUDA stream per FFT for, ComputeFFT.h:166-208), and device
memory is owned by JAX.

Strategies (plan.resolve_strategy(), chosen by plan.route under 'auto'):
  * STAGED — plain-JAX Stockham stage loop, one DFT-matrix product per stage
             (ops/stages_jax.py; XLA fuses what it can).
  * XLA    — jnp.fft: cuFFT on the GPU, the library the reference harness
             compares against.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tensorfft_tpu import dft
from tensorfft_tpu.plan import FFTPlan, Precision, Strategy, create_plan
from tensorfft_tpu.ops import stages_jax

__all__ = [
    "fft", "ifft", "fft_split", "ifft_split",
    "fft2", "ifft2", "fftn", "ifftn", "fftn_split", "ifftn_split",
]


def stage_scales(radices, scaling: str, forward: bool) -> Tuple[float, ...]:
    """Per-stage progressive scale factors.

    'forward' scaling is the reference convention: the forward transform is
    scaled by 1/N, applied one 1/radix per stage (TensorRadix16.cu:132-136) so
    the matching inverse is unscaled.  'none' is the NumPy convention.
    """
    if scaling == "forward":
        return tuple(1.0 / r for r in radices) if forward else tuple(1.0 for _ in radices)
    if scaling == "none":
        return tuple(1.0 for _ in radices) if forward else tuple(1.0 / r for r in radices)
    if scaling == "ortho":
        return tuple(r ** -0.5 for r in radices)
    raise ValueError(f"bad scaling {scaling!r}")


def _xla_fft(re, im, plan: FFTPlan, forward: bool, axis: int = -1):
    """The XLA route: ``jnp.fft`` along ``axis`` (cuFFT on the GPU).

    complex64 for every policy but float64, which runs in complex128.  The
    library's scaling conventions are numpy's ``norm`` modes: 'forward' is
    1/N on the forward transform, 'none' is numpy's 'backward', 'ortho' is
    'ortho'.
    """
    real = jnp.float64 if plan.precision is Precision.FLOAT64 else jnp.float32
    x = jax.lax.complex(re.astype(real), im.astype(real))
    norm = {"forward": "forward", "none": "backward", "ortho": "ortho"}[
        plan.scaling]
    fn = jnp.fft.fft if forward else jnp.fft.ifft
    x = fn(x, axis=axis, norm=norm)
    return jnp.real(x), jnp.imag(x)


def transform_major(re, im, plan: FFTPlan, forward: bool):
    """Transform along axis 0 of (N, B) planes on the plan's route.

    The per-shard engine of the distributed paths (parallel/pencil.py); the
    staged loop's native layout (ops/stages_jax.py).
    """
    n = re.shape[0]
    if n != plan.fft_length:
        raise ValueError(f"plan is for fft_length {plan.fft_length}, data has {n}")
    if plan.resolve_strategy() is Strategy.XLA:
        return _xla_fft(re, im, plan, forward, axis=0)
    sign = dft.FORWARD if forward else dft.INVERSE
    scales = stage_scales(plan.radices, plan.scaling, forward)
    return stages_jax.apply_stages(
        re, im, plan.radices, scales, sign,
        algorithm=plan.precision.dot_algorithm,
    )


@functools.partial(jax.jit, static_argnames=("plan", "forward"))
def _fft_split_jit(re, im, plan: FFTPlan, forward: bool):
    storage = plan.precision.storage_dtype
    re = re.astype(storage)
    im = im.astype(storage)
    out_re, out_im = _fft_split_core(re, im, plan, forward)
    return out_re.astype(storage), out_im.astype(storage)


def _fft_split_core(re, im, plan, forward):
    """Transform along the last axis; leading axes are batch."""
    if plan.resolve_strategy() is Strategy.XLA:
        return _xla_fft(re, im, plan, forward)
    batch_shape = re.shape[:-1]
    n = re.shape[-1]
    b = int(np.prod(batch_shape)) if batch_shape else 1
    out_re, out_im = transform_major(
        re.reshape(b, n).T, im.reshape(b, n).T, plan, forward)
    return (
        out_re.T.reshape(*batch_shape, n),
        out_im.T.reshape(*batch_shape, n),
    )


def _ensure_plan(n: int, plan: Optional[FFTPlan], **kwargs) -> FFTPlan:
    if plan is None:
        return create_plan(n, **kwargs)
    if plan.fft_length != n:
        raise ValueError(
            f"plan is for fft_length {plan.fft_length}, data has {n}"
        )
    return plan


def fft_split(re, im, plan: Optional[FFTPlan] = None, **plan_kwargs):
    """Forward FFT on split-complex planar data, transform along the last axis.

    This is the native API (reference parity: the reference's I/O contract is
    split planar __half arrays, ComputeFFT.h:1-16).  Leading axes are batch.
    With the default plan the output is scaled by 1/N (reference convention).
    """
    re = jnp.asarray(re)
    im = jnp.asarray(im)
    if re.shape != im.shape:
        raise ValueError(f"re/im shape mismatch: {re.shape} vs {im.shape}")
    plan = _ensure_plan(re.shape[-1], plan, **plan_kwargs)
    return _fft_split_jit(re, im, plan, True)


def ifft_split(re, im, plan: Optional[FFTPlan] = None, **plan_kwargs):
    """Inverse FFT on split planar data; exact inverse of :func:`fft_split`
    under the plan's scaling convention."""
    re = jnp.asarray(re)
    im = jnp.asarray(im)
    if re.shape != im.shape:
        raise ValueError(f"re/im shape mismatch: {re.shape} vs {im.shape}")
    plan = _ensure_plan(re.shape[-1], plan, **plan_kwargs)
    return _fft_split_jit(re, im, plan, False)


def _to_split(x):
    """Split a complex (or real) array into planar (re, im) on the host.

    The device-native representation is split planar, exactly like the
    reference's __half RE/IM arrays (ComputeFFT.h:1-16).
    """
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy())
    x = jnp.asarray(x)
    return x, jnp.zeros_like(x)


def _to_complex(re, im):
    return np.asarray(re, np.float32) + 1j * np.asarray(im, np.float32)


def fft(x, plan: Optional[FFTPlan] = None, **plan_kwargs):
    """Forward FFT of a complex (or real) array along the last axis.

    Host-boundary convenience wrapper over :func:`fft_split`: splits/joins
    complex data in NumPy (returns a NumPy complex64 array).  Use
    :func:`fft_split` to stay on device.
    """
    re, im = _to_split(x)
    o_re, o_im = fft_split(re, im, plan, **plan_kwargs)
    return _to_complex(o_re, o_im)


def ifft(x, plan: Optional[FFTPlan] = None, **plan_kwargs):
    re, im = _to_split(x)
    o_re, o_im = ifft_split(re, im, plan, **plan_kwargs)
    return _to_complex(o_re, o_im)


# ---------------------------------------------------------------------------
# Multi-dimensional transforms (row-column decomposition over the 1D engine).
# Beyond the reference's capability set (it is 1D-only); part of this repo's
# config-3/config-5 extensions.
# ---------------------------------------------------------------------------

def _fftn_split(re, im, axes, plans, forward, plan_kwargs):
    # Row-column decomposition: one 1D transform per axis.
    for ax in axes:
        re_m = jnp.moveaxis(re, ax, -1)
        im_m = jnp.moveaxis(im, ax, -1)
        n = re_m.shape[-1]
        plan = plans.get(n) if isinstance(plans, dict) else None
        kw = dict(plan_kwargs)
        kw.setdefault("tuning", "auto")  # inherit single-chip tuning wins
        plan = _ensure_plan(n, plan, **kw)
        fn = fft_split if forward else ifft_split
        re_m, im_m = fn(re_m, im_m, plan)
        re = jnp.moveaxis(re_m, -1, ax)
        im = jnp.moveaxis(im_m, -1, ax)
    return re, im


def fftn_split(re, im, axes=None, plans=None, **plan_kwargs):
    """N-dimensional FFT on split planar data (device-native path)."""
    re = jnp.asarray(re)
    im = jnp.asarray(im)
    if axes is None:
        axes = tuple(range(re.ndim))
    return _fftn_split(re, im, axes, plans or {}, True, plan_kwargs)


def ifftn_split(re, im, axes=None, plans=None, **plan_kwargs):
    re = jnp.asarray(re)
    im = jnp.asarray(im)
    if axes is None:
        axes = tuple(range(re.ndim))
    return _fftn_split(re, im, axes, plans or {}, False, plan_kwargs)


def fftn(x, axes=None, plans=None, **plan_kwargs):
    """N-dimensional FFT by row-column decomposition (forward scaling 1/N per
    axis by default, i.e. total 1/prod(shape)).  Host-boundary convenience
    wrapper; returns NumPy complex64."""
    re, im = _to_split(x)
    if axes is None:
        axes = tuple(range(re.ndim))
    re, im = _fftn_split(re, im, axes, plans or {}, True, plan_kwargs)
    return _to_complex(re, im)


def ifftn(x, axes=None, plans=None, **plan_kwargs):
    re, im = _to_split(x)
    if axes is None:
        axes = tuple(range(re.ndim))
    re, im = _fftn_split(re, im, axes, plans or {}, False, plan_kwargs)
    return _to_complex(re, im)


def fft2(x, axes=(-2, -1), plans=None, **plan_kwargs):
    return fftn(x, axes=axes, plans=plans, **plan_kwargs)


def ifft2(x, axes=(-2, -1), plans=None, **plan_kwargs):
    return ifftn(x, axes=axes, plans=plans, **plan_kwargs)
