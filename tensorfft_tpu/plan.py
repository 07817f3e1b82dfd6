"""FFT planning layer.

Re-design of the reference planner (``/root/reference/src/base/Plan.h``): the
reference ``Plan`` (Plan.h:18-39) validates the transform length, derives the
radix-16 / radix-2 stage factorization (Plan.h:99-100) and computes CUDA launch
geometry (warps per block, grid sizes, shared memory bytes, Plan.h:117-191).

Here launch geometry belongs to XLA: a plan is a pure function of
``(fft_length, precision policy, strategy)`` producing

  * the radix factorization (combine order) of the staged path, and
  * an execution strategy, which :func:`route` picks from the platform and
    the length when the caller leaves it on ``auto``,

and is passed as a *static* argument to ``jax.jit``.  The reference's
file-driven plan overload (Plan.h:197-255) maps to ``tuning`` lookups in the
per-platform JSON plan cache (see ``tensorfft_tpu.tuning``), and
``PlanWorksOnDevice`` (Plan.h:257-296) maps to :func:`plan_works_on_device`.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence, Tuple

__all__ = [
    "Precision",
    "Strategy",
    "FFTPlan",
    "create_plan",
    "route",
    "plan_works_on_device",
    "is_power_of_2",
    "exact_log2",
    "balanced_radices",
    "optimal_radices",
]

# Reference supports N >= 256 (Plan.h:85-96).  We accept any power of two >= 2
# (a strict superset); conformance tests sweep the reference range.
REFERENCE_MIN_LENGTH = 256

# Keys a tuning dict (create_plan(tuning=...), the plan cache) may carry.
TUNING_KEYS = ("radices", "strategy")


class Precision(str, enum.Enum):
    """Numeric policy, replacing the reference's fp16-everywhere choice.

    The reference stores data AND accumulates matmuls in fp16 via WMMA
    (TensorRadix16.cu:166-176).  Every policy here accumulates in fp32; a
    policy picks

      * the storage dtype between passes, and
      * the matmul operand decomposition ("dot algorithm") of the staged
        path: how many bf16 split terms represent each fp32 operand on the
        tensor cores.  'bf16x3' is split-precision compensation
        (x = hi + lo in bf16; three partial products recover ~fp32
        mantissa), implemented explicitly so CPU tests reproduce the
        device's numerics exactly.
    """

    BFLOAT16 = "bfloat16"      # bf16 storage, 1 bf16 product  (reference parity)
    FLOAT32 = "float32"        # f32 storage, bf16x3 compensated matmuls
    FLOAT32_X6 = "float32_x6"  # f32 storage, bf16x6 (near-exact f32) matmuls
    FLOAT64 = "float64"        # exact; oracle-grade path

    @property
    def storage_dtype(self):
        import jax.numpy as jnp

        return {
            Precision.BFLOAT16: jnp.bfloat16,
            Precision.FLOAT32: jnp.float32,
            Precision.FLOAT32_X6: jnp.float32,
            Precision.FLOAT64: jnp.float64,
        }[self]

    @property
    def compute_dtype(self):
        import jax.numpy as jnp

        return jnp.float64 if self is Precision.FLOAT64 else jnp.float32

    @property
    def dot_algorithm(self) -> str:
        """Operand decomposition for stage matmuls (see ops/dots.py)."""
        return {
            Precision.BFLOAT16: "bf16",
            Precision.FLOAT32: "bf16x3",
            Precision.FLOAT32_X6: "bf16x6",
            Precision.FLOAT64: "exact",
        }[self]


class Strategy(str, enum.Enum):
    """Execution strategy (the analog of the reference's Mode_256/Mode_4096,
    Plan.h:14, which selects how the transform is executed)."""

    AUTO = "auto"              # route(platform, length) decides
    STAGED = "staged"          # plain-JAX stage loop (XLA fuses what it can)
    XLA = "xla"                # jnp.fft: cuFFT on the GPU


def _parse_strategy(value) -> Strategy:
    try:
        return Strategy(value)
    except ValueError:
        names = ", ".join(repr(s.value) for s in Strategy)
        raise ValueError(
            f"unknown strategy {value!r}; the strategies are {names}"
        ) from None


def route(fft_length: int, platform: Optional[str] = None) -> Strategy:
    """The strategy ``auto`` resolves to for ``fft_length`` on ``platform``.

    The one place the library chooses an execution route.  On the GPU that
    is cuFFT (``jnp.fft``): timed against the staged stage loop on an H100
    (``bench.py --routes``: bf16 and float32 at N = 4096 and 16384 with
    batch 4096, N = 2^20 with batch 64), it was faster in every cell, by
    1.1x to 6.2x.  On the CPU it is the staged loop, so tests reproduce the
    stage numerics of the ``bf16``/``bf16x3`` policies.  ``platform``
    defaults to ``jax.default_backend()``; any other platform raises.
    """
    del fft_length  # every length takes the same route on both platforms
    if platform is None:
        import jax

        platform = jax.default_backend()
    if platform == "cpu":
        return Strategy.STAGED
    if platform == "gpu":
        return Strategy.XLA
    raise ValueError(
        f"no FFT route for platform {platform!r}; supported: 'gpu', 'cpu'"
    )


def is_power_of_2(x: int) -> bool:
    """Mirror of the reference IsPowerOf2 (Plan.h:41-47)."""
    return x > 0 and (x & (x - 1)) == 0


def exact_log2(x: int) -> int:
    """Mirror of the reference ExactLog2 (Plan.h:50-67); requires power of 2."""
    if not is_power_of_2(x):
        raise ValueError(f"{x} is not a power of 2")
    return x.bit_length() - 1


def balanced_radices(n: int) -> Tuple[int, ...]:
    """Factor n = 2^p into ceil(p/7) nearly-equal power-of-two radices <= 128.

    The reference factors N into one base-16 DFT + radix-16 steps + radix-2
    leftovers (Plan.h:99-100) because its tensor-core tile is 16x16.  Fewer,
    larger stages mean fewer passes over the data.
    """
    p = exact_log2(n)
    if p == 0:
        return ()
    max_log = 7
    stages = max(1, math.ceil(p / max_log))
    base, rem = divmod(p, stages)
    logs = [base + 1] * rem + [base] * (stages - rem)
    # First stage has no twiddle; order ascending so the cheap/no-twiddle stage
    # takes the smallest radix.
    logs.sort()
    return tuple(1 << l for l in logs)


# MAC cost per input element of one block-complex radix-R stage: the stage
# matmul is [[D_re,-D_im],[D_im,D_re]] (2R x 2R) @ (2R, N*B/R), with M and K
# counted as padded to 128.  c(R) = max(2R,128)^2 / R, minimized at R=64.
_STAGE_COST = {
    (1 << a): max(2 << a, 128) ** 2 // (1 << a) for a in range(1, 9)
}


def optimal_radices(n: int) -> Tuple[int, ...]:
    """Factor n = 2^p minimizing the total padded MACs of block-complex stages.

    Dynamic program over partitions of p with per-stage cost _STAGE_COST;
    radix 64 (block matrix 128x128) is the sweet spot of that model.
    Plausible alternatives (e.g. (32,128) vs (64,64) at N=4096) are explicit
    ``radices=`` or plan-cache choices.
    """
    p = exact_log2(n)
    if p == 0:
        return ()
    best: dict[int, Tuple[int, Tuple[int, ...]]] = {0: (0, ())}
    for q in range(1, p + 1):
        candidates = []
        for a in range(1, min(8, q) + 1):
            cost_tail, rad_tail = best[q - a]
            candidates.append((cost_tail + _STAGE_COST[1 << a], rad_tail + (1 << a,)))
        best[q] = min(candidates)
    radices = sorted(best[p][1])
    return tuple(radices)


@dataclasses.dataclass(frozen=True)
class FFTPlan:
    """Immutable description of how to execute one FFT configuration.

    Hashable so it can be a static argument to ``jax.jit``.  Counterpart of the
    reference ``struct Plan`` (Plan.h:18-39) minus device launch geometry.
    """

    fft_length: int
    radices: Tuple[int, ...]
    precision: Precision = Precision.BFLOAT16
    strategy: Strategy = Strategy.AUTO
    # Forward transform scale: 'forward' = 1/N progressively applied per stage
    # (the reference convention, TensorRadix16.cu:132-136), 'none', 'ortho'.
    scaling: str = "forward"

    def __post_init__(self):
        if not is_power_of_2(self.fft_length):
            raise ValueError(
                f"fft_length must be a power of 2, got {self.fft_length}"
            )
        if math.prod(self.radices) != self.fft_length:
            raise ValueError(
                f"radices {self.radices} do not multiply to {self.fft_length}"
            )
        for r in self.radices:
            if not is_power_of_2(r):
                raise ValueError(f"radix {r} is not a power of 2")
        if self.scaling not in ("forward", "none", "ortho"):
            raise ValueError(f"bad scaling {self.scaling!r}")
        object.__setattr__(self, "precision", Precision(self.precision))
        object.__setattr__(self, "strategy", _parse_strategy(self.strategy))

    # -- reference-parity accessors -------------------------------------------------
    @property
    def log2_length(self) -> int:
        return exact_log2(self.fft_length)

    @property
    def amount_of_stages(self) -> int:
        """Stage count (reference: amount_of_r16_steps_ + amount_of_r2_steps_ + 1)."""
        return len(self.radices)

    @property
    def stage_scale(self) -> Tuple[float, ...]:
        """Per-stage progressive scale factors (product = total scale).

        Reference parity: each stage divides by its radix so intermediates stay
        bounded (TensorFFT256.cu:167-171, Radix2.cu:67-76).
        """
        if self.scaling == "forward":
            return tuple(1.0 / r for r in self.radices)
        if self.scaling == "ortho":
            return tuple(r ** -0.5 for r in self.radices)
        return tuple(1.0 for _ in self.radices)

    def resolve_strategy(self) -> Strategy:
        if self.strategy is not Strategy.AUTO:
            return self.strategy
        return route(self.fft_length)


def create_plan(
    fft_length: int,
    precision: str | Precision = Precision.BFLOAT16,
    strategy: str | Strategy = Strategy.AUTO,
    radices: Optional[Sequence[int]] = None,
    scaling: str = "forward",
    tuning: Optional[dict] = None,
    batch_hint: Optional[int] = None,
) -> FFTPlan:
    """Create an :class:`FFTPlan`.

    Counterpart of the reference ``CreatePlan(fft_length, mode, ...)``
    (Plan.h:77-194).  The reference rejects lengths below 256 (Plan.h:85-96);
    we accept any power of two >= 2, a strict superset of the contract.

    ``tuning`` is a dict with keys from ``TUNING_KEYS`` (the analog of the
    reference's TunerResults.dat-driven overload, Plan.h:197-255); any key
    present overrides the computed default.  Pass ``tuning="auto"`` to look
    the current (fft_length, precision, platform) up in the persistent plan
    cache (no-op if the cache holds nothing for it).
    """
    if not is_power_of_2(fft_length) or fft_length < 2:
        raise ValueError(
            f"fft_length must be a power of 2 (>= 2), got {fft_length}"
        )
    precision = Precision(precision)
    strategy = _parse_strategy(strategy)

    if tuning == "auto":
        import jax

        from tensorfft_tpu.tuning import TunerCache

        # batch_hint selects a batch-specific cache entry when one exists
        # (plans themselves stay batch-agnostic).
        tuning = TunerCache().get(
            fft_length, precision.value, jax.devices()[0].platform,
            batch=batch_hint,
        )

    tuning = dict(tuning or {})
    unknown = sorted(set(tuning) - set(TUNING_KEYS))
    if unknown:
        raise ValueError(
            f"unknown tuning keys {unknown}; a plan takes {list(TUNING_KEYS)}"
        )
    if "radices" in tuning and radices is None:
        radices = tuple(tuning["radices"])
    if "strategy" in tuning and strategy is Strategy.AUTO:
        strategy = _parse_strategy(tuning["strategy"])
    if radices is None:
        radices = optimal_radices(fft_length)

    return FFTPlan(
        fft_length=int(fft_length),
        radices=tuple(int(r) for r in radices),
        precision=precision,
        strategy=strategy,
        scaling=scaling,
    )


def plan_works_on_device(plan: FFTPlan, device=None) -> Tuple[bool, str]:
    """Check that ``plan`` can run on ``device``.

    Counterpart of the reference ``PlanWorksOnDevice`` (Plan.h:257-296), which
    checks compute capability >= 8.0, warp size and opt-in shared memory.
    Here XLA owns launch geometry, so what remains is: a route exists for the
    device's platform, and a GPU has tensor cores of compute capability
    >= 8.0 (Plan.h:262-265).  Returns (ok, reason).
    """
    import jax

    if device is None:
        device = jax.devices()[0]
    platform = getattr(device, "platform", "cpu")
    try:
        if plan.strategy is Strategy.AUTO:
            route(plan.fft_length, platform)
    except ValueError as e:
        return (False, str(e))
    if platform == "gpu":
        cc = getattr(device, "compute_capability", None)
        if cc is None or float(cc) < 8.0:
            return (False, f"compute capability {cc} < 8.0 on {device}")
    elif platform != "cpu":
        return (False, f"no FFT route for platform {platform!r}")
    return (True, "ok")
