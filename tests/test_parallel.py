"""Multi-device tests on the 8-device virtual CPU mesh: real collectives run
(what the reference's dead multi-GPU code never could, ComputeFFT.h:295-557)."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import tensorfft_tpu as tfft
from tensorfft_tpu.parallel import (
    batch_sharded_fft,
    make_batch_mesh,
    pencil_fft_1d,
    pencil_fft_3d,
)


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    assert len(devs) == 8, "tests/conftest.py must configure 8 virtual devices"
    return Mesh(np.asarray(devs), ("sp",))


def test_batch_sharded_matches_local():
    n, batch = 1024, 16
    rng = np.random.default_rng(0)
    re = rng.standard_normal((batch, n)).astype(np.float32)
    im = rng.standard_normal((batch, n)).astype(np.float32)
    plan = tfft.create_plan(n, precision="float32", strategy="staged")
    mesh = make_batch_mesh()
    s_re, s_im = batch_sharded_fft(re, im, plan, mesh)
    l_re, l_im = tfft.fft_split(re, im, plan)
    np.testing.assert_allclose(np.asarray(s_re), np.asarray(l_re), atol=1e-6)
    np.testing.assert_allclose(np.asarray(s_im), np.asarray(l_im), atol=1e-6)
    assert len(s_re.sharding.device_set) == 8


@pytest.mark.parametrize("n,n1", [(1 << 12, 64), (1 << 14, 128), (1 << 14, None)])
def test_pencil_1d_matches_oracle(mesh8, n, n1):
    rng = np.random.default_rng(1)
    re = rng.standard_normal(n)
    im = rng.standard_normal(n)
    o_re, o_im = pencil_fft_1d(re, im, mesh8, n1=n1, precision='float32')
    x = re + 1j * im
    want = np.fft.fft(x) / n
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    assert np.abs(got - want).max() < 1e-5


def test_pencil_1d_batched(mesh8):
    n, batch = 1 << 12, 3
    rng = np.random.default_rng(2)
    re = rng.standard_normal((batch, n))
    im = rng.standard_normal((batch, n))
    o_re, o_im = pencil_fft_1d(re, im, mesh8, precision='float32')
    want = np.fft.fft(re + 1j * im, axis=-1) / n
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    assert np.abs(got - want).max() < 1e-5


def test_pencil_3d_matches_oracle(mesh8):
    nx, ny, nz = 32, 16, 64
    rng = np.random.default_rng(3)
    re = rng.standard_normal((nx, ny, nz))
    im = rng.standard_normal((nx, ny, nz))
    o_re, o_im = pencil_fft_3d(re, im, mesh8, precision='float32')
    want = np.fft.fftn(re + 1j * im) / (nx * ny * nz)
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    assert np.abs(got - want).max() < 1e-5


def test_pencil_1d_rejects_bad_split(mesh8):
    with pytest.raises(ValueError):
        pencil_fft_1d(np.ones(256), np.ones(256), mesh8, n1=4)  # 4 % 8 != 0


def test_pencil_3d_2d_mesh():
    devs = np.asarray(jax.devices()).reshape(2, 4)
    mesh = Mesh(devs, ("py", "pz"))
    from tensorfft_tpu.parallel import pencil_fft_3d_2d_mesh

    nx, ny, nz = 16, 32, 16
    rng = np.random.default_rng(7)
    re = rng.standard_normal((nx, ny, nz))
    im = rng.standard_normal((nx, ny, nz))
    o_re, o_im = pencil_fft_3d_2d_mesh(re, im, mesh, precision="float32")
    want = np.fft.fftn(re + 1j * im) / (nx * ny * nz)
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    assert np.abs(got - want).max() < 1e-5


def test_pencil_3d_2d_mesh_bad_divisibility():
    devs = np.asarray(jax.devices()).reshape(2, 4)
    mesh = Mesh(devs, ("py", "pz"))
    from tensorfft_tpu.parallel import pencil_fft_3d_2d_mesh

    with pytest.raises(ValueError):
        pencil_fft_3d_2d_mesh(np.ones((16, 6, 16)), np.ones((16, 6, 16)), mesh)


# --- Comm/compute-overlap (software-pipelined) variants -----------------
# Chunked scheduling must not change the math: compare against the
# monolithic path at tight tolerance AND against the fp64 oracle.

@pytest.mark.parametrize("overlap", [2, 4])
def test_pencil_1d_overlap_batched_matches(mesh8, overlap):
    n, batch = 1 << 12, 4
    rng = np.random.default_rng(11)
    re = rng.standard_normal((batch, n))
    im = rng.standard_normal((batch, n))
    base = pencil_fft_1d(re, im, mesh8, precision="float32")
    ovl = pencil_fft_1d(re, im, mesh8, precision="float32", overlap=overlap)
    np.testing.assert_allclose(np.asarray(ovl[0]), np.asarray(base[0]),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(ovl[1]), np.asarray(base[1]),
                               atol=1e-6)
    want = np.fft.fft(re + 1j * im, axis=-1) / n
    got = np.asarray(ovl[0], np.float64) + 1j * np.asarray(ovl[1], np.float64)
    assert np.abs(got - want).max() < 1e-5


def test_pencil_1d_overlap_single_fft_column_chunks(mesh8):
    # batch=1 cannot chunk the batch axis -> column chunking + reorder path.
    n = 1 << 14
    rng = np.random.default_rng(12)
    re = rng.standard_normal(n)
    im = rng.standard_normal(n)
    o_re, o_im = pencil_fft_1d(re, im, mesh8, precision="float32", overlap=4)
    want = np.fft.fft(re + 1j * im) / n
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    assert np.abs(got - want).max() < 1e-5


def test_pencil_3d_overlap_matches(mesh8):
    nx, ny, nz = 32, 16, 64
    rng = np.random.default_rng(13)
    re = rng.standard_normal((nx, ny, nz))
    im = rng.standard_normal((nx, ny, nz))
    base = pencil_fft_3d(re, im, mesh8, precision="float32")
    ovl = pencil_fft_3d(re, im, mesh8, precision="float32", overlap=4)
    np.testing.assert_allclose(np.asarray(ovl[0]), np.asarray(base[0]),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(ovl[1]), np.asarray(base[1]),
                               atol=1e-6)
    want = np.fft.fftn(re + 1j * im) / (nx * ny * nz)
    got = np.asarray(ovl[0], np.float64) + 1j * np.asarray(ovl[1], np.float64)
    assert np.abs(got - want).max() < 1e-5


def test_pencil_3d_2d_mesh_overlap_matches():
    devs = np.asarray(jax.devices()).reshape(2, 4)
    mesh = Mesh(devs, ("py", "pz"))
    from tensorfft_tpu.parallel import pencil_fft_3d_2d_mesh

    nx, ny, nz = 16, 32, 16
    rng = np.random.default_rng(14)
    re = rng.standard_normal((nx, ny, nz))
    im = rng.standard_normal((nx, ny, nz))
    base = pencil_fft_3d_2d_mesh(re, im, mesh, precision="float32")
    ovl = pencil_fft_3d_2d_mesh(re, im, mesh, precision="float32", overlap=2)
    np.testing.assert_allclose(np.asarray(ovl[0]), np.asarray(base[0]),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(ovl[1]), np.asarray(base[1]),
                               atol=1e-6)
    want = np.fft.fftn(re + 1j * im) / (nx * ny * nz)
    got = np.asarray(ovl[0], np.float64) + 1j * np.asarray(ovl[1], np.float64)
    assert np.abs(got - want).max() < 1e-5


def test_pencil_1d_overlap_rejects_indivisible(mesh8):
    # b=3 not divisible by 2 and n2p=8 not divisible by 3 -> error for c=3
    with pytest.raises(ValueError):
        pencil_fft_1d(np.ones((1, 256)), np.ones((1, 256)), mesh8,
                      n1=16, overlap=3)


def test_overlap_auto_pencil_paths(mesh8):
    # overlap="auto" consults the link/compute model (utils.device
    # .overlap_estimate) and must produce identical results to overlap=1.
    n = 1 << 12
    rng = np.random.default_rng(7)
    re = rng.standard_normal(n)
    im = rng.standard_normal(n)
    o_re, o_im = pencil_fft_1d(re, im, mesh8, precision="float32",
                               overlap="auto")
    want = np.fft.fft(re + 1j * im) / n
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    assert np.abs(got - want).max() < 1e-5

    nx = ny = nz = 16
    re3 = rng.standard_normal((nx, ny, nz))
    im3 = rng.standard_normal((nx, ny, nz))
    o3_re, o3_im = pencil_fft_3d(re3, im3, mesh8, precision="float32",
                                 overlap="auto")
    want3 = np.fft.fftn(re3 + 1j * im3) / (nx * ny * nz)
    got3 = np.asarray(o3_re, np.float64) + 1j * np.asarray(o3_im, np.float64)
    assert np.abs(got3 - want3).max() < 1e-5


def test_resolve_overlap_clamps_to_divisors():
    from tensorfft_tpu.parallel.pencil import resolve_overlap

    # Integer passthrough.
    assert resolve_overlap(4, 1 << 20, 8, 1e-3, [1, 2, 4]) == 4
    # Auto with balanced comm/compute on a big message recommends > 1,
    # clamped to the legal divisor list.
    from tensorfft_tpu.utils.device import all_to_all_seconds, device_spec

    spec = device_spec()
    t = all_to_all_seconds(64 << 20, 8, spec)
    c = resolve_overlap("auto", 64 << 20, 8, t, [1, 2])
    assert c in (1, 2)
    # No legal divisor -> 1.
    assert resolve_overlap("auto", 64 << 20, 8, t, []) == 1


def test_pencil_local_engine_consumes_tuner_cache(mesh8, tmp_path, monkeypatch):
    # Distributed paths inherit single-device plan choices: put a
    # cpu-platform entry in a temp plan cache and check (a) the per-shard
    # plan adopts its radices and strategy, and (b) the pencil path still
    # matches the oracle while consuming it.
    from tensorfft_tpu.parallel.pencil import _local_plan
    from tensorfft_tpu.plan import Strategy
    from tensorfft_tpu.tuning import TunerCache

    cache_path = tmp_path / "cache.json"
    monkeypatch.setenv("TENSORFFT_TUNER_CACHE", str(cache_path))
    c = TunerCache(cache_path)
    c.put(64, "float32", "cpu", {"radices": [4, 16], "strategy": "staged"})
    c.save()

    plan = _local_plan(64, "float32", "forward")
    assert plan.radices == (4, 16)     # not optimal_radices(64) == (64,)
    assert plan.resolve_strategy() is Strategy.STAGED

    n, n1 = 1 << 12, 64                # column pass length n1=64 is cached
    rng = np.random.default_rng(5)
    re = rng.standard_normal(n)
    im = rng.standard_normal(n)
    o_re, o_im = pencil_fft_1d(re, im, mesh8, n1=n1, precision="float32")
    x = re + 1j * im
    want = np.fft.fft(x) / n
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    assert np.abs(got - want).max() < 1e-5


def test_pencil_1d_overlap_issues_chunked_collectives(mesh8):
    # Shape-level schedule validation (round-3 verdict item 8): overlap=c
    # must issue exactly c chunked all_to_all collectives — the pipelined
    # schedule really splits the transpose, rather than repeating it.
    import jax

    from tensorfft_tpu.parallel import pencil_fft_1d

    rng = np.random.default_rng(0)
    n = 4096
    re = rng.standard_normal(n).astype(np.float32)
    im = rng.standard_normal(n).astype(np.float32)
    for ov in (1, 2, 4):
        jaxpr = jax.make_jaxpr(
            lambda a, b, ov=ov: pencil_fft_1d(
                a, b, mesh8, n1=16, precision="float32", overlap=ov)
        )(re, im)
        n_a2a = str(jaxpr).count("all_to_all")
        assert n_a2a == 2 * ov, (ov, n_a2a)  # one per plane (re, im)
