"""Stage-matmul dot algorithms: explicit bf16 operand decompositions.

The reference does complex multiply-accumulate in raw fp16 WMMA fragments
(TensorRadix16.cu:166-176).  Tensor cores consume bf16 operands at full rate
and accumulate in fp32; higher operand precision is recovered by splitting
each fp32 operand into bf16 terms and summing partial products (the
split-precision-compensation technique; XLA exposes the same idea as
DotAlgorithmPreset.BF16_BF16_F32_X3/X6).  We implement the splits explicitly
so numerics are identical on the CPU (tests) and the GPU, and no f32 product
is left to a backend default (TF32 on the GPU keeps about three digits).

Algorithms:
  'bf16'   — round operands to bf16, 1 product        (reference-fp16 analog)
  'bf16x3' — 2-term split, 3 products (~fp32-grade for FFT stage dots)
  'bf16x6' — 3-term split, 6 products (near-exact fp32)
  'exact'  — plain dot in the operand dtype with HIGHEST precision (f64 path)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["dot", "split_bf16"]


def split_bf16(x, terms: int):
    """Split fp32 ``x`` into ``terms`` bf16 arrays summing to ~x.

    Each term captures ~8 further mantissa bits.  The leading terms are
    extracted by masking the low 16 mantissa bits (truncation) rather than by
    a bf16 round-trip: an excess-precision simplifier may fold
    ``x - f32(bf16(x))`` into ``x - x = 0``, silently destroying the
    compensation — bitmasking is opaque to that rewrite and the masked value
    converts to bf16 exactly.
    """
    parts = []
    resid = x.astype(jnp.float32)
    for _ in range(terms - 1):
        u = jax.lax.bitcast_convert_type(resid, jnp.uint32)
        hi = jax.lax.bitcast_convert_type(
            u & jnp.uint32(0xFFFF0000), jnp.float32
        )
        parts.append(hi.astype(jnp.bfloat16))  # exact: low mantissa bits are 0
        resid = resid - hi
    parts.append(resid.astype(jnp.bfloat16))
    return parts


def _dot_f32(a, b):
    return jax.lax.dot(a, b, preferred_element_type=jnp.float32)


def dot(a, b, algorithm: str = "bf16"):
    """a @ b with fp32 accumulation under the given operand decomposition.

    ``a`` is typically a small DFT matrix (constant; splits constant-fold),
    ``b`` the data panel.
    """
    if algorithm == "exact":
        return jax.lax.dot(
            a, b,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=a.dtype,
        )
    if algorithm == "bf16":
        return _dot_f32(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16))
    if algorithm == "bf16x3":
        a_hi, a_lo = split_bf16(a, 2)
        b_hi, b_lo = split_bf16(b, 2)
        return _dot_f32(a_hi, b_hi) + (_dot_f32(a_hi, b_lo) + _dot_f32(a_lo, b_hi))
    if algorithm == "bf16x6":
        a0, a1, a2 = split_bf16(a, 3)
        b0, b1, b2 = split_bf16(b, 3)
        return (
            _dot_f32(a0, b0)
            + (_dot_f32(a0, b1) + _dot_f32(a1, b0))
            + (_dot_f32(a0, b2) + _dot_f32(a1, b1) + _dot_f32(a2, b0))
        )
    raise ValueError(f"unknown dot algorithm {algorithm!r}")
