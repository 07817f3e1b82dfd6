"""Profiler integration.

The reference's only profiling support is wall-clock timers plus dedicated
binaries to aim nvprof/nsight at (CuFFTExample.cu:1 "Used to profile").  The
equivalents here are jax.profiler traces (viewable in XProf / perfetto /
TensorBoard).  A failure to start or stop tracing raises.
"""
from __future__ import annotations

import contextlib
import time

__all__ = ["profile_trace", "annotate"]


@contextlib.contextmanager
def profile_trace(log_dir: str, label: str = "tfft"):
    """Capture a jax.profiler trace around the body into ``log_dir``.

    Usage:
        with profile_trace("chiprun_out/trace"):
            out = fft_split(re, im, plan)
            jax.block_until_ready(out)
    """
    import jax

    t0 = time.perf_counter_ns()
    jax.profiler.start_trace(log_dir)
    try:
        with jax.profiler.TraceAnnotation(label):
            yield
    finally:
        jax.profiler.stop_trace()
        dt = (time.perf_counter_ns() - t0) / 1e6
        print(f"[profile_trace] {label}: {dt:.3f} ms wall, trace in {log_dir}")


def annotate(label: str):
    """TraceAnnotation decorator for hot functions (no-op off-trace)."""
    import functools

    import jax

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with jax.profiler.TraceAnnotation(label):
                return fn(*args, **kwargs)

        return wrapped

    return deco
