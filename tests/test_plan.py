import dataclasses
import math

import pytest

from tensorfft_tpu.plan import (
    FFTPlan,
    Strategy,
    balanced_radices,
    create_plan,
    exact_log2,
    is_power_of_2,
    plan_works_on_device,
    route,
)


def test_is_power_of_2():
    assert is_power_of_2(1)
    assert is_power_of_2(256)
    assert not is_power_of_2(0)
    assert not is_power_of_2(255)
    assert not is_power_of_2(-4)


def test_exact_log2():
    assert exact_log2(4096) == 12
    with pytest.raises(ValueError):
        exact_log2(12)


@pytest.mark.parametrize("p", range(1, 28))
def test_balanced_radices_cover_all_powers(p):
    n = 1 << p
    radices = balanced_radices(n)
    assert math.prod(radices) == n
    assert all(2 <= r <= 256 for r in radices)
    # Stage count is minimal for radices <= 128.
    assert len(radices) == max(1, math.ceil(p / 7))


def test_create_plan_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        create_plan(1000)
    with pytest.raises(ValueError):
        create_plan(0)


def test_plan_is_hashable_static_arg():
    a = create_plan(4096)
    b = create_plan(4096)
    assert a == b
    assert hash(a) == hash(b)
    assert a != create_plan(8192)


def test_stage_scale_progressive():
    plan = create_plan(4096, radices=(16, 16, 16))
    assert plan.stage_scale == (1 / 16, 1 / 16, 1 / 16)
    assert abs(math.prod(plan.stage_scale) - 1 / 4096) < 1e-12


def test_plan_works_on_device_cpu():
    ok, reason = plan_works_on_device(create_plan(4096))
    assert ok, reason


def test_plan_validation():
    with pytest.raises(ValueError):
        FFTPlan(fft_length=4096, radices=(16, 16))  # product mismatch
    with pytest.raises(ValueError):
        FFTPlan(fft_length=4096, radices=(16, 16, 16), scaling="bogus")


def test_tuning_overrides():
    plan = create_plan(
        1 << 16,
        tuning={"radices": (16, 16, 16, 16), "strategy": "xla"},
    )
    assert plan.radices == (16, 16, 16, 16)
    assert plan.resolve_strategy() == Strategy.XLA


# -- route: the one choice of execution strategy -------------------------------

@pytest.mark.parametrize("p", [1, 8, 12, 14, 15, 20, 24, 28])
def test_route_cpu_is_staged(p):
    # The CPU reproduces the stage numerics of the bf16/bf16x3 policies.
    assert route(1 << p, "cpu") is Strategy.STAGED


@pytest.mark.parametrize("p", [1, 8, 12, 14, 15, 20, 24, 28])
def test_route_gpu_is_cufft(p):
    # cuFFT beat the staged loop in every measured H100 cell (plan.route).
    assert route(1 << p, "gpu") is Strategy.XLA


def test_route_default_platform_is_jax_backend():
    import jax

    assert route(4096) is route(4096, jax.default_backend())


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_route_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no FFT route"):
        route(4096, platform)


def test_auto_resolves_through_route():
    # Under the test suite's CPU platform, AUTO is the staged loop.
    plan = create_plan(4096)
    assert plan.strategy is Strategy.AUTO
    assert plan.resolve_strategy() is route(4096) is Strategy.STAGED
    assert create_plan(4096, strategy="xla").resolve_strategy() is Strategy.XLA


@pytest.mark.parametrize("removed", ["fused", "four_step"])
def test_removed_strategies_raise(removed):
    with pytest.raises(ValueError, match="'auto', 'staged', 'xla'"):
        create_plan(4096, strategy=removed)
    with pytest.raises(ValueError, match="'auto', 'staged', 'xla'"):
        FFTPlan(fft_length=256, radices=(16, 16), strategy=removed)
    with pytest.raises(ValueError, match="'auto', 'staged', 'xla'"):
        create_plan(4096, tuning={"strategy": removed})


@pytest.mark.parametrize("knob", [
    "lane_tile", "grouped", "state_dtype", "kloop_width", "complex_mult",
    "engine", "first_dot", "k1_tile", "interleave_downcast", "fused_layout",
    "max_fused_length", "four_step_split", "col_radices", "row_radices",
])
def test_removed_plan_knobs_are_refused(knob):
    # Neither a plan field nor a tuning key any more.
    assert knob not in {f.name for f in dataclasses.fields(FFTPlan)}
    with pytest.raises(ValueError, match="unknown tuning keys"):
        create_plan(4096, tuning={knob: 1})


class _FakeGPU:
    """Duck-typed CUDA device: plan_works_on_device reads these attrs."""

    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"

    def __init__(self, compute_capability):
        self.compute_capability = compute_capability


@pytest.mark.parametrize("cc,ok", [("9.0", True), ("8.0", True),
                                   ("7.5", False), (None, False)])
def test_plan_works_on_device_gpu_compute_capability(cc, ok):
    # Reference parity: tensor-core FFTs need compute capability >= 8.0
    # (Plan.h:262-265).
    got, reason = plan_works_on_device(create_plan(4096), _FakeGPU(cc))
    assert got is ok, reason


def test_plan_works_on_device_unknown_platform():
    class _Other:
        platform = "rocm"

    ok, reason = plan_works_on_device(create_plan(4096), _Other())
    assert not ok and "no FFT route" in reason
