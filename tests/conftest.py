"""Test configuration.

By default tests run on the CPU with 8 virtual devices, so the multi-device
paths (tensorfft_tpu.parallel) execute real collectives without a GPU.  The
environment must be set before jax imports.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them when JAX sees no GPU.  Run them on
the card with

    TENSORFFT_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu
"""
import os

if os.environ.get("TENSORFFT_TEST_PLATFORM") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if os.environ.get("TENSORFFT_TEST_PLATFORM") != "gpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)")


def pytest_addoption(parser):
    parser.addoption(
        "--full-conformance",
        action="store_true",
        default=False,
        help="run the full reference conformance sweep (N=256..2^20, 10 seeds)",
    )


@pytest.fixture
def full_conformance(request):
    return request.config.getoption("--full-conformance")


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test when there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU: run with TENSORFFT_TEST_PLATFORM=gpu "
                    "on a machine with one")
    return gpus[0]
