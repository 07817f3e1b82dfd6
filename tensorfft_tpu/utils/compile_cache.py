"""JAX's persistent compilation cache for the entry-point scripts.

``chip_smoke.py``, ``bench.py`` and the scripts under ``benchmarks/`` call
:func:`enable_compile_cache` before their first compilation.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing else is
set.  Otherwise the cache lives at a fixed directory inside the checkout
(``.jax_cache/``, listed in ``.gitignore``): the path is part of the cache
key, so a directory that moved would never hit.
"""
from __future__ import annotations

import os
from pathlib import Path

__all__ = ["enable_compile_cache", "default_cache_dir"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> Path:
    """``.jax_cache/`` at the root of the checkout."""
    return Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's compilation cache at its directory; return the path."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    path = str(default_cache_dir())
    jax.config.update("jax_compilation_cache_dir", path)
    return path
