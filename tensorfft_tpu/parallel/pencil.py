"""Distributed transforms: one FFT sharded across chips.

No analog exists in the reference (its dead multi-GPU code had zero
inter-device communication, ComputeFFT.h:295-557); this is the config-5
extension from BASELINE.md.  The global transposes of the Bailey/pencil
decomposition are `jax.lax.all_to_all` collectives under `shard_map`, which
XLA hands to NCCL (NVLink between the cards of one host).

1D: distributed four-step.  x viewed (n1, n2) with the n2 axis sharded:
    local column FFTs (length n1) -> twiddle (per-shard table slice) ->
    tiled all_to_all (the global transpose) -> local row FFTs (length n2).
    Output is in natural frequency order, sharded over the k1 digit.

3D: slab decomposition over a 1D mesh.  x (nx, ny, nz) sharded over nx:
    local FFTs along z and y -> all_to_all swapping the sharded axis from
    x to z -> local FFTs along x.  (A 2D-mesh pencil variant splits two
    axes; the slab is the P<=nx special case and uses one collective.)
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tensorfft_tpu import dft
from tensorfft_tpu.fft import transform_major
from tensorfft_tpu.plan import FFTPlan, create_plan, exact_log2

__all__ = ["pencil_fft_1d", "pencil_fft_3d", "pencil_fft_3d_2d_mesh"]


def _pipelined(states, *stage_fns):
    """Software-pipeline ``stage_fns`` over independent chunk ``states``.

    Traces stage s of chunk i immediately after stage s+1 of chunk i-1
    (skewed order), so every collective stage is adjacent in program order
    to compute stages of *other* chunks that do not depend on it.  XLA's
    latency-hiding scheduler then overlaps the async collective with that
    compute (SURVEY hard part 4: overlap of communication with per-pencil
    compute is where scaling is won or lost).  Chunks are
    semantically independent, so results are identical to the monolithic
    path; only the schedule changes.
    """
    states = list(states)
    c = len(states)
    s = len(stage_fns)
    for t in range(c + s - 1):
        for stage in range(min(s - 1, t), -1, -1):
            i = t - stage
            if 0 <= i < c:
                states[i] = stage_fns[stage](states[i])
    return states


def _chunk_reorder_concat(chunks, p, axis):
    """Undo per-chunk all_to_all interleaving on the concat axis.

    Chunking the concat-source axis into C pieces makes each chunk's tiled
    all_to_all deliver sh[axis] = p*csz entries ordered (device, j) within
    the chunk, while the global order over the whole axis is
    (device, chunk, j).  Stack the chunk results, lift the device digit
    above the chunk digit, and flatten: global = r*(C*csz) + c*csz + j.
    """
    c = len(chunks)
    if c == 1:
        return chunks[0]
    sh = chunks[0].shape
    axis = axis % len(sh)
    csz = sh[axis] // p
    x = jnp.stack(chunks, axis=0)  # (C, *sh)
    x = x.reshape((c,) + sh[:axis] + (p, csz) + sh[axis + 1:])
    x = jnp.moveaxis(x, 0, axis + 1)  # (*sh[:axis], p, C, csz, *rest)
    return x.reshape(sh[:axis] + (p * c * csz,) + sh[axis + 1:])


def _local_plan(n: int, precision: str, scaling: str) -> FFTPlan:
    """Plan of one per-shard transform of length ``n``: what the
    single-device path would take, plan-cache entries included."""
    return create_plan(n, precision=precision, scaling=scaling, tuning="auto")


def resolve_overlap(overlap, local_bytes, n_devices, local_fft_seconds,
                    divisor_candidates):
    """Map overlap='auto' to a model-recommended chunk count.

    Consults utils.device.overlap_estimate (link all_to_all roofline vs the
    local FFT compute it can hide behind) and clamps the recommendation to
    the largest legal divisor <= the recommendation, so the result always
    satisfies the path's chunking constraint.  Integers pass through.
    """
    if overlap != "auto":
        return max(1, int(overlap))
    from tensorfft_tpu.utils.device import overlap_estimate

    est = overlap_estimate(local_bytes, n_devices, local_fft_seconds)
    c = est.chunks
    legal = [d for d in divisor_candidates if d <= c] or [1]
    return max(legal)


def pencil_fft_1d(
    re,
    im,
    mesh: Mesh,
    axis_name: str = "sp",
    n1: Optional[int] = None,
    scaling: str = "forward",
    forward: bool = True,
    precision: str = "bfloat16",
    overlap: int | str = 1,
) -> Tuple[jax.Array, jax.Array]:
    """One large 1D FFT distributed over the mesh (distributed four-step).

    ``re``/``im``: (..., N) split planar.  N = n1*n2 with n2 divisible by the
    mesh size and n1 divisible by the mesh size.  Returns (..., N) in natural
    frequency order, block-sharded over the mesh along the last axis (the
    shard_map leaves k sharded over its minor k1 digit; one resharding moves
    it to contiguous blocks rather than gathering it onto every device).

    ``overlap`` > 1 software-pipelines the global transpose: the data is cut
    into ``overlap`` independent chunks (along the batch axis when divisible,
    else along the local j2 columns) and each chunk's all_to_all is
    interleaved with other chunks' local FFT compute, hiding link latency
    behind compute (the comm/compute-overlap technique the single-device
    reference had no use for).  Results are identical for any value.
    """
    re = jnp.asarray(re)
    im = jnp.asarray(im)
    batch_shape = re.shape[:-1]
    n = re.shape[-1]
    b = int(np.prod(batch_shape)) if batch_shape else 1
    p = mesh.shape[axis_name]
    if n1 is None:
        n1 = 1 << (exact_log2(n) // 2)
    n2 = n // n1
    if n1 % p or n2 % p:
        raise ValueError(f"n1={n1}, n2={n2} must both be divisible by mesh size {p}")
    sign = dft.FORWARD if forward else dft.INVERSE
    plan1 = _local_plan(n1, precision, scaling)
    plan2 = _local_plan(n2, precision, scaling)
    n2p = n2 // p
    n1p = n1 // p

    if overlap == "auto":
        from tensorfft_tpu.utils.device import fft_roofline_seconds

        itemsize = 2 if precision == "bfloat16" else 4
        local_bytes = 2 * b * n1 * n2p * itemsize
        divisors = [d for d in (1, 2, 4, 8)
                    if (b % d == 0 and b >= d) or n2p % d == 0]
        overlap = resolve_overlap(
            overlap, local_bytes, p,
            fft_roofline_seconds(n1, b * n2p, plan1.radices, itemsize), divisors,
        )
    c = max(1, int(overlap))
    chunk_batch = b % c == 0 and b >= c
    if not chunk_batch and n2p % c:
        raise ValueError(
            f"overlap={c} must divide the batch ({b}) or local columns ({n2p})"
        )

    # Twiddle tables, rank-separated so each shard slices its own column:
    # W[k1, q*n2p + j2l] = pcol[k1, q] * q_tab[k1, j2l].
    k1g = np.arange(n1, dtype=np.float64)[:, None]
    ph_p = (2.0 * np.pi * sign / n) * (k1g * (np.arange(p, dtype=np.float64)[None, :] * n2p))
    ph_q = (2.0 * np.pi * sign / n) * (k1g * np.arange(n2p, dtype=np.float64)[None, :])
    pcol = np.stack([np.cos(ph_p), np.sin(ph_p)]).astype(np.float32)  # (2, n1, p)
    qtab = np.stack([np.cos(ph_q), np.sin(ph_q)]).astype(np.float32)  # (2, n1, n2p)

    def shard_fn(re_l, im_l, pcol_l, qtab_l):
        # re_l: (b, n1, n2p) — the j2 axis is sharded.
        q = jax.lax.axis_index(axis_name)
        pr = jax.lax.dynamic_slice_in_dim(pcol_l[0], q, 1, axis=1)
        pi = jax.lax.dynamic_slice_in_dim(pcol_l[1], q, 1, axis=1)
        w_re_full = pr * qtab_l[0] - pi * qtab_l[1]   # (n1, n2p)
        w_im_full = pr * qtab_l[1] + pi * qtab_l[0]

        def pass1_twiddle(state):
            # state: ((bb, n1, cc) re/im, cols slice into n2p)
            re_c, im_c, cols = state
            bb, _, cc = re_c.shape
            a_re = jnp.moveaxis(re_c, 1, 0).reshape(n1, bb * cc)
            a_im = jnp.moveaxis(im_c, 1, 0).reshape(n1, bb * cc)
            a_re, a_im = transform_major(a_re, a_im, plan1, forward)
            a_re = a_re.reshape(n1, bb, cc)
            a_im = a_im.reshape(n1, bb, cc)
            w_re = w_re_full[:, None, cols]
            w_im = w_im_full[:, None, cols]
            return (a_re * w_re - a_im * w_im, a_re * w_im + a_im * w_re)

        def transpose_a2a(state):
            # Global transpose: shard axis moves from j2 to k1.
            a_re, a_im = state
            a_re = jax.lax.all_to_all(a_re, axis_name, split_axis=0,
                                      concat_axis=2, tiled=True)
            a_im = jax.lax.all_to_all(a_im, axis_name, split_axis=0,
                                      concat_axis=2, tiled=True)
            return a_re, a_im

        def pass2(state):
            # state: (n1p, bb, n2) with full j2.  FFT over j2.
            a_re, a_im = state
            bb = a_re.shape[1]
            a_re = jnp.moveaxis(a_re, 2, 0).reshape(n2, n1p * bb)
            a_im = jnp.moveaxis(a_im, 2, 0).reshape(n2, n1p * bb)
            a_re, a_im = transform_major(a_re, a_im, plan2, forward)
            # (k2, k1l, bb) -> (bb, k2, k1l): global (b, n2, n1) is natural k.
            a_re = a_re.reshape(n2, n1p, bb).transpose(2, 0, 1)
            a_im = a_im.reshape(n2, n1p, bb).transpose(2, 0, 1)
            return a_re, a_im

        full = slice(0, n2p)
        if chunk_batch:
            bc = b // c
            chunks = [
                (re_l[i * bc:(i + 1) * bc], im_l[i * bc:(i + 1) * bc], full)
                for i in range(c)
            ]
            outs = _pipelined(chunks, pass1_twiddle, transpose_a2a, pass2)
            a_re = jnp.concatenate([o[0] for o in outs], axis=0)
            a_im = jnp.concatenate([o[1] for o in outs], axis=0)
            return a_re, a_im
        # Column chunking (b not divisible; e.g. one giant FFT, b = 1):
        # pipeline pass 1 + transpose per column chunk, then one pass 2.
        csz = n2p // c
        chunks = [
            (re_l[:, :, i * csz:(i + 1) * csz],
             im_l[:, :, i * csz:(i + 1) * csz],
             slice(i * csz, (i + 1) * csz))
            for i in range(c)
        ]
        outs = _pipelined(chunks, pass1_twiddle, transpose_a2a)
        a_re = _chunk_reorder_concat([o[0] for o in outs], p, axis=2)
        a_im = _chunk_reorder_concat([o[1] for o in outs], p, axis=2)
        return pass2((a_re, a_im))

    from jax import shard_map

    in_spec = P(None, None, axis_name)
    tab_spec = P(None, None, None)
    out_spec = P(None, None, axis_name)
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(in_spec, in_spec, tab_spec, tab_spec),
        out_specs=(out_spec, out_spec),
        check_vma=False,
    )
    re3 = re.reshape(b, n1, n2)
    im3 = im.reshape(b, n1, n2)
    out_sharding = NamedSharding(
        mesh, P(*([None] * len(batch_shape)), axis_name))

    @functools.partial(jax.jit, out_shardings=(out_sharding, out_sharding))
    def run(re3, im3, pcol, qtab):
        o_re, o_im = fn(re3, im3, pcol, qtab)
        return o_re.reshape(*batch_shape, n), o_im.reshape(*batch_shape, n)

    return run(re3, im3, jnp.asarray(pcol), jnp.asarray(qtab))


def pencil_fft_3d(
    re,
    im,
    mesh: Mesh,
    axis_name: str = "sp",
    scaling: str = "forward",
    forward: bool = True,
    precision: str = "bfloat16",
    overlap: int | str = 1,
) -> Tuple[jax.Array, jax.Array]:
    """3D FFT of a (nx, ny, nz) volume, slab-sharded over nx.

    Local FFTs along z then y, one all_to_all moving the shard from x to z,
    local FFTs along x.  Output (kx, ky, kz) with kz sharded.  Total forward
    scale 1/(nx*ny*nz) under 'forward' scaling.

    ``overlap`` > 1 (must divide ny) pipelines the global transpose in ky
    chunks: chunk i's all_to_all is on the wire while chunk i-1's x-axis
    FFTs run.  Results are identical for any value.
    """
    re = jnp.asarray(re)
    im = jnp.asarray(im)
    nx, ny, nz = re.shape
    p = mesh.shape[axis_name]
    if nx % p or nz % p:
        raise ValueError(f"nx={nx} and nz={nz} must be divisible by mesh size {p}")
    if overlap == "auto":
        from tensorfft_tpu.utils.device import fft_roofline_seconds

        itemsize = 2 if precision == "bfloat16" else 4
        local_bytes = 2 * (nx // p) * ny * nz * itemsize
        divisors = [d for d in (1, 2, 4, 8) if ny % d == 0]
        overlap = resolve_overlap(
            overlap, local_bytes, p,
            fft_roofline_seconds(nx, (nz // p) * ny,
                                 _local_plan(nx, precision, scaling).radices,
                                 itemsize),
            divisors,
        )
    c = max(1, int(overlap))
    if ny % c:
        raise ValueError(f"overlap={c} must divide ny={ny}")

    def axis_fft(a_re, a_im, length, batch):
        plan = _local_plan(length, precision, scaling)
        return transform_major(a_re.reshape(length, batch),
                               a_im.reshape(length, batch), plan, forward)

    def shard_fn(re_l, im_l):
        nxp = nx // p
        nzp = nz // p
        # FFT along z: transform-major (nz, nxp*ny).
        a_re = jnp.moveaxis(re_l, 2, 0)
        a_im = jnp.moveaxis(im_l, 2, 0)
        a_re, a_im = axis_fft(a_re, a_im, nz, nxp * ny)
        a_re = a_re.reshape(nz, nxp, ny)
        a_im = a_im.reshape(nz, nxp, ny)
        # FFT along y: (ny, nz*nxp).
        a_re = jnp.moveaxis(a_re, 2, 0)
        a_im = jnp.moveaxis(a_im, 2, 0)
        a_re, a_im = axis_fft(a_re, a_im, ny, nz * nxp)
        a_re = a_re.reshape(ny, nz, nxp)  # (ky, kz, x_local)
        a_im = a_im.reshape(ny, nz, nxp)

        def transpose_a2a(state):
            # Global transpose: shard moves x -> z.
            s_re, s_im = state
            s_re = jax.lax.all_to_all(s_re, axis_name, split_axis=1,
                                      concat_axis=2, tiled=True)
            s_im = jax.lax.all_to_all(s_im, axis_name, split_axis=1,
                                      concat_axis=2, tiled=True)
            return s_re, s_im

        def x_fft(state):
            # (kyc, nz/p, nx): FFT along x.
            s_re, s_im = state
            kyc = s_re.shape[0]
            s_re = jnp.moveaxis(s_re, 2, 0)
            s_im = jnp.moveaxis(s_im, 2, 0)
            s_re, s_im = axis_fft(s_re, s_im, nx, kyc * nzp)
            return s_re.reshape(nx, kyc, nzp), s_im.reshape(nx, kyc, nzp)

        kyc = ny // c
        chunks = [
            (a_re[i * kyc:(i + 1) * kyc], a_im[i * kyc:(i + 1) * kyc])
            for i in range(c)
        ]
        outs = _pipelined(chunks, transpose_a2a, x_fft)
        # (kx, ky, kz_local)
        return (
            jnp.concatenate([o[0] for o in outs], axis=1),
            jnp.concatenate([o[1] for o in outs], axis=1),
        )

    from jax import shard_map

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis_name, None, None), P(axis_name, None, None)),
        out_specs=(P(None, None, axis_name), P(None, None, axis_name)),
        check_vma=False,
    )
    return jax.jit(fn)(re, im)


def pencil_fft_3d_2d_mesh(
    re,
    im,
    mesh: Mesh,
    axis_names: Tuple[str, str] = ("py", "pz"),
    scaling: str = "forward",
    forward: bool = True,
    precision: str = "bfloat16",
    overlap: int | str = 1,
) -> Tuple[jax.Array, jax.Array]:
    """True pencil-decomposed 3D FFT over a 2D device mesh (py x pz).

    A 1D mesh can only slab; here the volume is split into x-pencils —
    local (nx, ny/py, nz/pz) — and each transpose is a tiled all_to_all over
    ONE mesh axis, so each collective spans one mesh row or column:

        FFT x  ->  all_to_all(py): x<->y  ->  FFT y
               ->  all_to_all(pz): y<->z  ->  FFT z

    Output (kx, ky, kz) sharded (py, pz, None).  Total forward scale
    1/(nx*ny*nz) under 'forward' scaling.

    ``overlap`` > 1 (must divide nz/pz) pipelines BOTH global transposes:
    each local-z chunk flows x-FFT -> all_to_all(py) -> y-FFT ->
    all_to_all(pz) independently, so while one chunk is on the wire the
    neighbors' FFT stages run (SURVEY hard part 4).  The z-axis
    FFT needs every chunk and runs once at the end.  Results identical.
    """
    re = jnp.asarray(re)
    im = jnp.asarray(im)
    nx, ny, nz = re.shape
    ax_y, ax_z = axis_names
    py = mesh.shape[ax_y]
    pz = mesh.shape[ax_z]
    if ny % py or nx % py or nz % pz or ny % pz:
        raise ValueError(
            f"(nx, ny, nz)=({nx},{ny},{nz}) must be divisible by mesh "
            f"({py},{pz}) on the exchanged axes"
        )
    if overlap == "auto":
        from tensorfft_tpu.utils.device import fft_roofline_seconds

        itemsize = 2 if precision == "bfloat16" else 4
        local_bytes = 2 * nx * (ny // py) * (nz // pz) * itemsize
        divisors = [d for d in (1, 2, 4, 8) if (nz // pz) % d == 0]
        overlap = resolve_overlap(
            overlap, local_bytes, max(py, pz),
            fft_roofline_seconds(nx, (ny // py) * (nz // pz),
                                 _local_plan(nx, precision, scaling).radices,
                                 itemsize),
            divisors,
        )
    c = max(1, int(overlap))
    if (nz // pz) % c:
        raise ValueError(f"overlap={c} must divide the local z extent {nz // pz}")

    def axis_fft(a_re, a_im, length, batch):
        plan = _local_plan(length, precision, scaling)
        return transform_major(a_re.reshape(length, batch),
                               a_im.reshape(length, batch), plan, forward)

    def shard_fn(re_l, im_l):
        nyl, nzl = ny // py, nz // pz
        nxl = nx // py
        nyl2 = ny // pz
        csz = nzl // c

        def x_fft(state):
            # (nx, nyl, csz): FFT along x (full locally).
            s_re, s_im = state
            s_re, s_im = axis_fft(s_re, s_im, nx, nyl * csz)
            return s_re.reshape(nx, nyl, csz), s_im.reshape(nx, nyl, csz)

        def a2a_y(state):
            # Transpose x<->y within py groups: -> (nx/py, ny, csz).
            s_re, s_im = state
            s_re = jax.lax.all_to_all(s_re, ax_y, split_axis=0,
                                      concat_axis=1, tiled=True)
            s_im = jax.lax.all_to_all(s_im, ax_y, split_axis=0,
                                      concat_axis=1, tiled=True)
            return s_re, s_im

        def y_fft(state):
            # FFT along y: (ny, nxl*csz).
            s_re, s_im = state
            s_re = jnp.moveaxis(s_re, 1, 0)
            s_im = jnp.moveaxis(s_im, 1, 0)
            s_re, s_im = axis_fft(s_re, s_im, ny, nxl * csz)
            return s_re.reshape(ny, nxl, csz), s_im.reshape(ny, nxl, csz)

        def a2a_z(state):
            # Transpose y<->z within pz groups: -> (ny/pz, nxl, pz*csz).
            s_re, s_im = state
            s_re = jax.lax.all_to_all(s_re, ax_z, split_axis=0,
                                      concat_axis=2, tiled=True)
            s_im = jax.lax.all_to_all(s_im, ax_z, split_axis=0,
                                      concat_axis=2, tiled=True)
            return s_re, s_im

        chunks = [
            (re_l[:, :, i * csz:(i + 1) * csz],
             im_l[:, :, i * csz:(i + 1) * csz])
            for i in range(c)
        ]
        outs = _pipelined(chunks, x_fft, a2a_y, y_fft, a2a_z)
        a_re = _chunk_reorder_concat([o[0] for o in outs], pz, axis=2)
        a_im = _chunk_reorder_concat([o[1] for o in outs], pz, axis=2)
        # FFT along z: (nz, nyl2*nxl).
        a_re = jnp.moveaxis(a_re, 2, 0)
        a_im = jnp.moveaxis(a_im, 2, 0)
        a_re, a_im = axis_fft(a_re, a_im, nz, nyl2 * nxl)
        # state (kz, ky_l2, kx_l) -> local (kx_l, ky_l2, kz)
        a_re = a_re.reshape(nz, nyl2, nxl).transpose(2, 1, 0)
        a_im = a_im.reshape(nz, nyl2, nxl).transpose(2, 1, 0)
        return a_re, a_im

    from jax import shard_map

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(None, ax_y, ax_z), P(None, ax_y, ax_z)),
        out_specs=(P(ax_y, ax_z, None), P(ax_y, ax_z, None)),
        check_vma=False,
    )
    return jax.jit(fn)(re, im)
