"""Audit of the matrix products a traced function issues.

On the GPU an f32 x f32 product left at the default precision may run in
TF32, which keeps about three decimal digits.  Every stage product of this
library takes explicit bf16 operands or ``Precision.HIGHEST``
(ops/dots.py); :func:`default_precision_f32_dots` finds any that does not.
"""
from __future__ import annotations

__all__ = ["default_precision_f32_dots"]


def _sub_jaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _walk(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _walk(sub)


def default_precision_f32_dots(fn, *args, **kwargs) -> list:
    """dot_general equations of ``fn(*args)`` that multiply float32 operands
    without ``Precision.HIGHEST`` (an empty list means none can run in TF32).
    """
    import jax
    import jax.numpy as jnp

    highest = jax.lax.Precision.HIGHEST
    closed = jax.make_jaxpr(fn)(*args, **kwargs)
    bad = []
    for eqn in _walk(closed.jaxpr):
        if eqn.primitive.name != "dot_general":
            continue
        if not any(v.aval.dtype == jnp.float32 for v in eqn.invars):
            continue
        precision = eqn.params.get("precision")
        if isinstance(precision, tuple) and all(p == highest for p in precision):
            continue
        if precision == highest:
            continue
        bad.append(eqn)
    return bad
