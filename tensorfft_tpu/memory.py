"""Device memory and layout conventions.

The reference owns device memory explicitly: DataHandler cudaMallocs 4N
halves partitioned into input-RE/input-IM/result-RE/result-IM and copies
split-complex host buffers across (DataHandler.h:22-82); DataBatchHandler
batches that (:86-166); ComputeFFT ping-pongs the input/result arrays and
tracks which holds the answer via ``results_in_results_`` (Plan.h:109-115).

Under JAX none of that machinery exists: JAX owns allocation, jit owns the
ping-pong, and donation replaces the explicit result-buffer protocol.  This
module is the thin, documented surface of that mapping — host staging into
the split planar device layout, optional buffer donation, and helpers the
test/bench harness uses to place data before timing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tensorfft_tpu.plan import FFTPlan

__all__ = [
    "to_device_split",
    "from_device_split",
    "interleaved_to_split",
    "split_to_interleaved",
    "donate_fft",
]


def to_device_split(
    re, im, plan: Optional[FFTPlan] = None, device=None
) -> Tuple[jax.Array, jax.Array]:
    """Stage split planar host data onto the device in the plan's storage
    dtype (the CopyDataHostToDevice analog, DataHandler.h:45-53)."""
    dtype = plan.precision.storage_dtype if plan else jnp.bfloat16
    re_d = jax.device_put(jnp.asarray(re, dtype), device)
    im_d = jax.device_put(jnp.asarray(im, dtype), device)
    return re_d, im_d


def from_device_split(re_d, im_d, dtype=np.float32):
    """Fetch results to host numpy (CopyResultsDeviceToHost analog,
    DataHandler.h:55-70 — no results_in_results_ parity needed: jitted
    execution has no user-visible ping-pong)."""
    return np.asarray(re_d, dtype), np.asarray(im_d, dtype)


def interleaved_to_split(buf):
    """Split the reference's host I/O format — one array of 2N reals, RE in
    the first half, IM in the second (ComputeFFT.h:1-16) — into planes."""
    buf = np.asarray(buf)
    n = buf.shape[-1] // 2
    return buf[..., :n].copy(), buf[..., n:].copy()


def split_to_interleaved(re, im):
    """Inverse of :func:`interleaved_to_split`."""
    return np.concatenate([np.asarray(re), np.asarray(im)], axis=-1)


def donate_fft(plan: FFTPlan, forward: bool = True):
    """A jitted FFT whose input buffers are donated (the JAX
    equivalent of the reference reusing its input arrays as the ping-pong
    scratch, ComputeFFT.h:89-120): XLA may alias them for the output,
    halving peak HBM residency for in-place-style pipelines."""
    from tensorfft_tpu.fft import _fft_split_core

    def fn(re, im):
        storage = plan.precision.storage_dtype
        o_re, o_im = _fft_split_core(
            re.astype(storage), im.astype(storage), plan, forward
        )
        return o_re.astype(storage), o_im.astype(storage)

    return jax.jit(fn, donate_argnums=(0, 1))
