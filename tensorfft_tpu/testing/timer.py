"""Wall-clock measurement utilities.

Mirror of the reference Timer.h (ScopeTimer/IntervallTimer over
std::chrono::high_resolution_clock, Timer.h:8-93) and the Benchmark
measurement loop (Bench.h:74-150): warmup iterations, then `samples` timed
runs of the compute path only, returning mean and sigma in nanoseconds.  The
reference brackets kernels with cudaDeviceSynchronize; the JAX analog is
jax.block_until_ready on the outputs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

__all__ = ["IntervalTimer", "ScopeTimer", "BenchResult", "measure"]


class IntervalTimer:
    """Reference IntervallTimer parity (Timer.h:44-93)."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter_ns()

    def get_time_in_nanoseconds(self) -> int:
        return time.perf_counter_ns() - self._t0

    def get_time_in_microseconds(self) -> float:
        return self.get_time_in_nanoseconds() / 1e3

    def get_time_in_milliseconds(self) -> float:
        return self.get_time_in_nanoseconds() / 1e6


class ScopeTimer:
    """Context manager printing elapsed time at scope exit (Timer.h:8-42)."""

    def __init__(self, label: str = "scope", unit: str = "ms"):
        self.label = label
        self.unit = unit

    def __enter__(self):
        self._timer = IntervalTimer()
        return self._timer

    def __exit__(self, *exc):
        ns = self._timer.get_time_in_nanoseconds()
        scale = {"ns": 1, "us": 1e3, "ms": 1e6, "s": 1e9}[self.unit]
        print(f"[{self.label}] {ns / scale:.3f} {self.unit}")
        return False


@dataclasses.dataclass(frozen=True)
class BenchResult:
    """Reference BenchUtil.h BenchResult parity (average + sigma, ns)."""

    average_time_ns: float
    std_deviation_ns: float
    samples: int

    @property
    def average_time_ms(self) -> float:
        return self.average_time_ns / 1e6


def measure(
    fn: Callable,
    args: Sequence = (),
    warmup: int = 5,
    samples: int = 100,
) -> BenchResult:
    """Time fn(*args) with block_until_ready bracketing (Bench.h:121-142 analog).

    The first call includes compilation; warmup runs are discarded.
    """
    import jax

    for _ in range(max(warmup, 1)):
        out = fn(*args)
        jax.block_until_ready(out)
    times = np.empty(samples, dtype=np.float64)
    for i in range(samples):
        t0 = time.perf_counter_ns()
        out = fn(*args)
        jax.block_until_ready(out)
        times[i] = time.perf_counter_ns() - t0
    return BenchResult(
        average_time_ns=float(times.mean()),
        std_deviation_ns=float(times.std()),
        samples=samples,
    )
