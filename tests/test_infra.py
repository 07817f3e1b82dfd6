"""Infrastructure-level checks: bench entry point, graft entry points,
twiddle table accuracy (TwiddleTest.cu analog), device peaks and models,
compile-cache setup."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def test_bench_smoke_emits_json():
    # The benchmark refuses the CPU (no device number from a CPU run) and
    # prints no result there; its per-cell measurement still runs here at a
    # tiny size and yields a JSON-serializable record.
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, str(REPO / "bench.py")],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]

    sys.path.insert(0, str(REPO))
    import bench

    rec = json.loads(json.dumps(bench.measure_config(256, 8, "bfloat16",
                                                     samples=2)))
    assert rec["strategy"] == "staged" and rec["time_us"] > 0
    assert rec["vs_baseline"] > 0 and rec["baseline_time_us"] > 0


def test_graft_entry_compiles():
    import jax

    sys.path.insert(0, str(REPO))
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out[0].shape == (256, 4096)


def test_twiddle_table_accuracy():
    """TwiddleTest.cu analog: the reference compared cos/cosf/hcos twiddle
    accuracy on device (TwiddleTest.cu:9-125).  Here: the fp32-rounded tables
    must be within 1 ulp of the fp64 values, and the bf16 block matrices
    within bf16 resolution."""
    from tensorfft_tpu import dft

    re64, im64 = dft._dft_matrix_f64(64, -1)
    re32, im32 = dft.dft_matrix(64, dtype=np.float32)
    assert np.abs(re32.astype(np.float64) - re64).max() < 6e-8
    assert np.abs(im32.astype(np.float64) - im64).max() < 6e-8
    w32 = dft.stage_twiddle(64, 512, dtype=np.float32)
    w64 = dft._stage_twiddle_f64(64, 512, -1)
    assert np.abs(w32[0].astype(np.float64) - w64[0]).max() < 6e-8


def test_device_spec_and_roofline():
    from tensorfft_tpu.utils import device_spec, fft_roofline_seconds
    from tensorfft_tpu.utils.device import H100_SXM, VIRTUAL_CPU_MESH

    # On the CPU the spec is the labelled virtual-mesh placeholder.
    assert device_spec() is VIRTUAL_CPU_MESH
    assert "not a measurement" in VIRTUAL_CPU_MESH.source
    # Memory-bound at radix 64: 2 planes read + written once, bf16.
    t = fft_roofline_seconds(4096, 4096, (64, 64), 2, spec=H100_SXM)
    assert t == pytest.approx(4 * 4096 * 4096 * 2 / 3.35e12)
    # Radix-16384 single stage: 8*R flops per point outweigh the bytes.
    t_big = fft_roofline_seconds(16384, 4096, (16384,), 2, spec=H100_SXM)
    assert t_big == pytest.approx(8 * 16384 * 16384 * 4096 / 989e12)


def test_plan_auto_tuning_lookup():
    import tensorfft_tpu as tfft

    # On CPU there is no cache entry: "auto" must degrade to defaults.
    plan = tfft.create_plan(4096, tuning="auto")
    assert plan.fft_length == 4096


def test_profile_trace_graceful(tmp_path):
    import jax.numpy as jnp

    from tensorfft_tpu.testing.profiling import annotate, profile_trace

    with profile_trace(str(tmp_path / "trace"), label="unit"):
        x = jnp.ones(8) + 1
        x.block_until_ready()
    assert list((tmp_path / "trace").rglob("*.xplane.pb"))

    @annotate("unit-fn")
    def f(v):
        return v * 2

    assert float(f(jnp.float32(2.0))) == 4.0


def test_write_log(tmp_path):
    from tensorfft_tpu.testing.io import write_log

    p = tmp_path / "log.txt"
    write_log(p, ["a", "b\n"])
    write_log(p, ["c"])
    assert p.read_text() == "a\nb\nc\n"


def test_overlap_perf_model():
    # NVLink roofline + pipelining model: BASELINE config 5 is the 512^3
    # distributed 3D FFT, here on four H100s (450 GB/s each way, every card
    # reaching every other at that rate).  The model must (a) price comm at
    # the link roofline, (b) recommend overlap when comm and compute are
    # comparable, and (c) recommend none when one side dominates.
    from tensorfft_tpu.utils.device import (
        H100_SXM,
        all_to_all_seconds,
        overlap_estimate,
    )

    # 512^3 split-complex f32: 8 bytes/point, 4 cards.
    local_bytes = (512 ** 3 // 4) * 8
    t_comm = all_to_all_seconds(local_bytes, 4, H100_SXM)
    assert t_comm == pytest.approx(local_bytes * 3 / 4 / (450e9 * 0.8))

    # Balanced comm/compute: overlap should win substantially.
    est = overlap_estimate(local_bytes, 4, compute_seconds=t_comm,
                           spec=H100_SXM)
    assert est.chunks > 1
    assert est.speedup > 1.4  # 2-stage fill bound caps balanced overlap

    # Compute-dominated (tiny message): chunk latency makes c=1 optimal or
    # near-optimal.
    est2 = overlap_estimate(1 << 10, 4, compute_seconds=1e-3, spec=H100_SXM)
    assert est2.speedup < 1.05

    # Single device: no comm at all.
    assert all_to_all_seconds(local_bytes, 1, H100_SXM) == 0.0


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3"])
def test_peak_table_known_kind(kind):
    from tensorfft_tpu.utils import PEAKS, device_spec

    class _Dev:
        platform = "gpu"
        device_kind = kind

    spec = device_spec(_Dev())
    assert spec is PEAKS[kind]
    assert (spec.bf16_flops, spec.hbm_bandwidth, spec.link_bandwidth) == (
        989e12, 3.35e12, 450e9)
    assert "data sheet" in spec.source and "700 W" in spec.source


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                                  "AMD Instinct MI300X", ""])
def test_peak_table_unknown_kind_raises(kind):
    from tensorfft_tpu.utils import device_spec

    class _Dev:
        platform = "gpu"
        device_kind = kind

    with pytest.raises(ValueError, match="no published peaks"):
        device_spec(_Dev())


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    import jax

    from tensorfft_tpu.utils import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing else is set.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    import jax

    from tensorfft_tpu.utils import enable_compile_cache
    from tensorfft_tpu.utils.compile_cache import default_cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == str(REPO / ".jax_cache") == str(default_cache_dir())
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    # The directory is never committed.
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
