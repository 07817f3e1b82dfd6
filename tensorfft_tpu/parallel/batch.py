"""Batch data parallelism over a device mesh.

Supersession of the reference's (dead) multi-GPU path, which looped
``cudaSetDevice`` to run independent FFTs per GPU with no communication
(ComputeFFT.h:295-557).  Here the batch axis is sharded over a 1D mesh and the
single-chip jitted pipeline runs unchanged — XLA partitions it; no collectives
are needed because batched FFTs are embarrassingly parallel across the batch.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tensorfft_tpu.fft import _fft_split_jit
from tensorfft_tpu.plan import FFTPlan

__all__ = ["make_batch_mesh", "batch_sharded_fft"]


def make_batch_mesh(devices=None, axis_name: str = "dp") -> Mesh:
    """1D mesh over all (or given) devices for batch data parallelism."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def batch_sharded_fft(
    re,
    im,
    plan: FFTPlan,
    mesh: Optional[Mesh] = None,
    axis_name: str = "dp",
    forward: bool = True,
):
    """FFT over the last axis with the leading batch axis sharded over ``mesh``.

    Inputs of shape (B, ..., N) with B divisible by the mesh size.  Returns
    sharded outputs (same sharding as inputs).
    """
    if mesh is None:
        mesh = make_batch_mesh(axis_name=axis_name)
    ndim = np.ndim(re)
    spec = P(axis_name, *([None] * (ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    re = jax.device_put(re, sharding)
    im = jax.device_put(im, sharding)
    fn = jax.jit(
        lambda a, b: _fft_split_jit(a, b, plan, forward),
        in_shardings=(sharding, sharding),
        out_shardings=(sharding, sharding),
    )
    return fn(re, im)
