"""Smoke run of tensorfft_tpu on NVIDIA GPUs, through the public API.

    python chip_smoke.py           # one card: the single-device phases
    python chip_smoke.py --four    # four cards: the distributed phases only

Every phase runs at the full size of a deployment the library supports, on
the route ``plan.route`` picks for the card, and is checked against the fp64
host oracle (``testing.fft_oracle``) under the reference gate: average
<= 1e-3, sigma <= 1e-2, max <= 0.5 absolute deviation on 1/N-scaled output
(UnitTest.cu:14-16).  Phases that need a tighter or a different check state
it beside the check.  The script refuses any platform but ``gpu``, exits
non-zero if any phase fails, and prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tensorfft_tpu as tfft  # noqa: E402
from tensorfft_tpu.testing import (  # noqa: E402
    deviation,
    fft_oracle,
    fftn_oracle,
    make_test_signal,
)

# Timed repetitions of each phase's step after one warm-up call.
REPS = 5


class PhaseFailed(AssertionError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise PhaseFailed(what)


def timed(fn, *args, reps: int = REPS):
    """(last output, median seconds): one warm-up call (compiles), then
    ``reps`` calls each ended by block_until_ready."""
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def signal_batch(n: int, batch: int, seed: int = 1):
    """(batch, n) fp64 planes of the reference's unit-test signals.

    Four sine superpositions with cutoff 20, weights seeded 42*i and
    42*42*i (UnitTest.cu:21-24); row b is base b % 4 circularly shifted by b
    places, so no two rows are alike and a batch mix-up cannot hide.
    """
    bases = [make_test_signal(n, 42 * (seed + i), 42 * 42 * (seed + i))
             for i in range(4)]
    re = np.empty((batch, n))
    im = np.empty((batch, n))
    for b in range(batch):
        s_re, s_im = bases[b % 4]
        re[b] = np.roll(s_re, -b)
        im[b] = np.roll(s_im, -b)
    return re, im


def _as64(planes):
    return tuple(np.asarray(p, np.float64) for p in planes)


def _gate(d, what: str):
    print(f"  {what}: {d}  limits avg<=1e-3 sigma<=1e-2 max<=0.5")
    check(d.passes_reference_gate(), f"{what} misses the reference gate: {d}")
    for v in (d.average, d.sigma, d.maximum):
        check(np.isfinite(v), f"{what}: non-finite deviation {d}")


def _finite(planes, what: str):
    for p in planes:
        check(bool(np.isfinite(np.asarray(p, np.float64)).all()),
              f"{what}: non-finite output")


def _other_route(strategy):
    from tensorfft_tpu.plan import Strategy

    return Strategy.STAGED if strategy is Strategy.XLA else Strategy.XLA


def phase_c2c(n: int, batch: int, precision: str, max_limit=None,
              memory: bool = False):
    """Forward C2C at (batch, n) on the routed strategy and on the other
    route, each against the fp64 oracle under the gate (plus ``max_limit``
    on the maximum deviation when given)."""
    import jax.numpy as jnp

    from tensorfft_tpu.fft import _fft_split_jit
    from tensorfft_tpu.testing.precision import default_precision_f32_dots

    re64, im64 = signal_batch(n, batch)
    want = fft_oracle(re64, im64)
    storage = tfft.Precision(precision).storage_dtype
    re = jnp.asarray(re64, storage)
    im = jnp.asarray(im64, storage)
    routed = tfft.route(n)
    result = {"route": routed.value}
    for strategy in (routed, _other_route(routed)):
        plan = tfft.create_plan(n, precision=precision, strategy=strategy)
        step = lambda a, b, plan=plan: tfft.fft_split(a, b, plan)
        bad = default_precision_f32_dots(step, re, im)
        check(not bad, f"f32 products at default precision (TF32): {bad}")
        out, secs = timed(step, re, im)
        check(out[0].shape == (batch, n) and out[0].dtype == storage,
              f"output {out[0].shape} {out[0].dtype}")
        got = _as64(out)
        _finite(got, strategy.value)
        d = deviation(got, want)
        tag = f"{strategy.value}{' (routed)' if strategy is routed else ''}"
        print(f"  {tag}: {secs * 1e6:.1f} us per call")
        _gate(d, tag)
        if max_limit is not None:
            print(f"  {tag}: max {d.maximum:.3e}  limit {max_limit:g}")
            check(d.maximum <= max_limit,
                  f"{tag}: max deviation {d.maximum:.3e} > {max_limit:g}")
        if memory and strategy is routed:
            compiled = _fft_split_jit.lower(re, im, plan, True).compile()
            print(f"  memory_analysis: {_memory_line(compiled)}")
        result[strategy.value] = {"us": secs * 1e6, "avg": d.average,
                                  "sigma": d.sigma, "max": d.maximum}
    return result


def _memory_line(compiled) -> str:
    stats = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    return ", ".join(f"{f}={getattr(stats, f, None)}" for f in fields)


def phase_roundtrip(n: int, batch: int, precision: str = "bfloat16"):
    """ifft_split(fft_split(x)) against x.  Tolerance relative to the signal:
    mean |err| <= 1e-2 rms(x) and max |err| <= 5e-2 max|x| for bf16 storage
    (8-bit mantissa, rounded at the input, the spectrum and the output:
    about 3 x 2^-9 = 6e-3 per element); 1e-4 / 1e-3 for float32 (bf16x3
    stage products keep about 16 mantissa bits)."""
    import jax.numpy as jnp

    re64, im64 = signal_batch(n, batch, seed=5)
    storage = tfft.Precision(precision).storage_dtype
    plan = tfft.create_plan(n, precision=precision)
    step = lambda a, b: tfft.ifft_split(*tfft.fft_split(a, b, plan), plan)
    out, secs = timed(step, jnp.asarray(re64, storage),
                      jnp.asarray(im64, storage))
    got = _as64(out)
    _finite(got, "roundtrip")
    err = np.abs(np.concatenate([got[0] - re64, got[1] - im64]).ravel())
    x = np.abs(np.concatenate([re64, im64]).ravel())
    rms = float(np.sqrt(np.mean(x ** 2)))
    mean_lim, max_lim = (1e-2, 5e-2) if precision == "bfloat16" else (1e-4, 1e-3)
    rel_mean = float(err.mean()) / rms
    rel_max = float(err.max()) / float(x.max())
    print(f"  route {plan.resolve_strategy().value}: {secs * 1e6:.1f} us per "
          f"fwd+inv; mean err/rms {rel_mean:.3e} limit {mean_lim:g}, "
          f"max err/max {rel_max:.3e} limit {max_lim:g}")
    check(rel_mean <= mean_lim and rel_max <= max_lim, "roundtrip error")
    return {"us": secs * 1e6, "rel_mean": rel_mean, "rel_max": rel_max}


def phase_rfft(n: int, batch: int, precision: str = "float32"):
    """rfft_split against the fp64 oracle (np.fft.rfft / N) under the gate,
    and irfft_split(rfft_split(x)) against x: mean |err| <= 1e-4 rms(x),
    max |err| <= 1e-3 max|x| (float32 policy: bf16x3 stage products keep
    about 16 mantissa bits, and the error grows with the stage count)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    x64 = rng.standard_normal((batch, n))
    want = np.fft.rfft(x64, axis=-1) / n
    plan = tfft.create_plan(n // 2, precision=precision)
    x = jnp.asarray(x64, plan.precision.storage_dtype)
    spec, secs_f = timed(lambda a: tfft.rfft_split(a, plan), x)
    got = _as64(spec)
    _finite(got, "rfft")
    check(got[0].shape == (batch, n // 2 + 1), f"rfft shape {got[0].shape}")
    print(f"  route {plan.resolve_strategy().value} (half length {n // 2}): "
          f"rfft {secs_f * 1e6:.1f} us")
    _gate(deviation(got, (want.real, want.imag)), "rfft vs oracle")
    back, secs_b = timed(lambda a, b: tfft.irfft_split(a, b, plan), *spec)
    back = np.asarray(back, np.float64)
    _finite((back,), "irfft")
    err = np.abs(back - x64)
    rms = float(np.sqrt(np.mean(x64 ** 2)))
    rel_mean = float(err.mean()) / rms
    rel_max = float(err.max()) / float(np.abs(x64).max())
    print(f"  irfft {secs_b * 1e6:.1f} us; roundtrip mean err/rms "
          f"{rel_mean:.3e} limit 1e-4, max err/max {rel_max:.3e} limit 1e-3")
    check(rel_mean <= 1e-4 and rel_max <= 1e-3, "rfft roundtrip error")
    return {"rfft_us": secs_f * 1e6, "irfft_us": secs_b * 1e6,
            "rel_mean": rel_mean, "rel_max": rel_max}


def phase_conv2d(h: int, w: int, precision: str = "float32"):
    """models.fft_convolve_2d against ifft2(fft2(a) * fft2(b)) by jnp.fft on
    the card: max |diff| <= 1e-4 max|want| (float32 on both sides)."""
    import jax
    import jax.numpy as jnp

    from tensorfft_tpu.models import fft_convolve_2d

    rng = np.random.default_rng(3)
    img = jnp.asarray(rng.standard_normal((h, w)), jnp.float32)
    ker = jnp.asarray(rng.standard_normal((h, w)), jnp.float32)
    got, secs = timed(lambda a, b: fft_convolve_2d(a, b, precision), img, ker)
    ref = jax.jit(lambda a, b: jnp.real(
        jnp.fft.ifft2(jnp.fft.fft2(a) * jnp.fft.fft2(b))))(img, ker)
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    _finite((got,), "conv2d")
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"  route {tfft.route(h).value}/{tfft.route(w).value}: "
          f"{secs * 1e6:.1f} us; max|diff|/max|jnp.fft| {rel:.3e} limit 1e-4")
    check(rel <= 1e-4, "conv2d disagrees with jnp.fft")
    return {"us": secs * 1e6, "rel_max": rel}


# -- four cards ------------------------------------------------------------

def _on_devices(arrays, n_devices: int, what: str):
    """Each output's shards sit on ``n_devices`` distinct devices and are
    not copies of the whole array."""
    for a in arrays:
        devs = {s.device for s in a.addressable_shards}
        replicated = a.sharding.is_fully_replicated
        print(f"  {what}: output sharded over {len(devs)} devices, "
              f"shard shape {a.addressable_shards[0].data.shape}")
        check(len(devs) == n_devices and not replicated,
              f"{what}: output on {len(devs)} devices, "
              f"fully replicated={replicated}")


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _sharded(mesh, spec, *arrays):
    """Place host arrays on ``mesh`` as the path reads them, so the timed
    calls measure device work and collectives, not host transfers."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    sharding = NamedSharding(mesh, PartitionSpec(*spec))
    return [jax.device_put(a, sharding) for a in arrays]


def _single_card(fn, *args):
    """Run ``fn`` on the first device alone (the single-card comparison)."""
    import jax

    dev = jax.devices()[0]
    args = [jax.device_put(np.asarray(a), dev) for a in args]
    return jax.jit(fn)(*args)


def phase_batch_sharded(n: int, batch: int, n_devices: int):
    """parallel.batch_sharded_fft (float32): against the fp64 oracle under
    the gate and against single-card jnp.fft (max |diff| <= 1e-4 max)."""
    import jax
    import jax.numpy as jnp

    from tensorfft_tpu.parallel import batch_sharded_fft, make_batch_mesh

    re64, im64 = signal_batch(n, batch, seed=9)
    plan = tfft.create_plan(n, precision="float32")
    mesh = make_batch_mesh(jax.devices()[:n_devices])
    out, secs = timed(lambda a, b: batch_sharded_fft(a, b, plan, mesh),
                      *_sharded(mesh, ("dp", None), re64.astype(np.float32),
                                im64.astype(np.float32)))
    _on_devices(out, n_devices, "batch_sharded_fft")
    got = _as64(out)
    _finite(got, "batch_sharded_fft")
    print(f"  {secs * 1e6:.1f} us per call")
    _gate(deviation(got, fft_oracle(re64, im64)), "batch_sharded_fft vs oracle")
    ref = _single_card(
        lambda a, b: jnp.fft.fft(a + 1j * b, axis=-1, norm="forward"),
        re64.astype(np.float32), im64.astype(np.float32))
    ref = np.asarray(ref)
    rel = _rel(got[0] + 1j * got[1], ref)
    print(f"  vs single-card jnp.fft: {rel:.3e} limit 1e-4")
    check(rel <= 1e-4, "batch_sharded_fft disagrees with jnp.fft")
    return {"us": secs * 1e6, "rel_jnp": rel}


def phase_pencil_1d(n: int, n_devices: int):
    """pencil_fft_1d (float32) at overlap=1 and 'auto': each against the
    fp64 oracle under the gate and single-card jnp.fft (<= 1e-4 max)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tensorfft_tpu.parallel import pencil_fft_1d

    re64, im64 = make_test_signal(n, 11, 12)
    want = fft_oracle(re64, im64)
    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("sp",))
    re = re64.astype(np.float32)
    im = im64.astype(np.float32)
    ref = np.asarray(_single_card(
        lambda a, b: jnp.fft.fft(a + 1j * b, norm="forward"), re, im))
    placed = _sharded(mesh, ("sp",), re, im)
    out = {}
    for overlap in (1, "auto"):
        o, secs = timed(lambda a, b: pencil_fft_1d(
            a, b, mesh, precision="float32", overlap=overlap), *placed)
        _on_devices(o, n_devices, f"pencil_fft_1d overlap={overlap}")
        got = _as64(o)
        _finite(got, "pencil_fft_1d")
        print(f"  overlap={overlap}: {secs * 1e6:.1f} us per call")
        _gate(deviation(got, want), f"pencil_fft_1d overlap={overlap}")
        rel = _rel(got[0] + 1j * got[1], ref)
        print(f"  vs single-card jnp.fft: {rel:.3e} limit 1e-4")
        check(rel <= 1e-4, "pencil_fft_1d disagrees with jnp.fft")
        out[str(overlap)] = {"us": secs * 1e6, "rel_jnp": rel}
    return out


def phase_pencil_3d(n: int, n_devices: int):
    """pencil_fft_3d on a slab mesh and pencil_fft_3d_2d_mesh on a 2x2 mesh
    (float32), each against the fp64 oracle under the gate and single-card
    jnp.fft.fftn (<= 1e-4 max)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tensorfft_tpu.parallel import pencil_fft_3d, pencil_fft_3d_2d_mesh

    rng = np.random.default_rng(13)
    re64 = rng.standard_normal((n, n, n))
    im64 = rng.standard_normal((n, n, n))
    want = fftn_oracle(re64, im64)
    re = re64.astype(np.float32)
    im = im64.astype(np.float32)
    ref = np.asarray(_single_card(
        lambda a, b: jnp.fft.fftn(a + 1j * b, norm="forward"), re, im))
    devs = np.asarray(jax.devices()[:n_devices])
    cases = {
        "slab": (pencil_fft_3d, Mesh(devs, ("sp",)), ("sp", None, None)),
        "2x2": (pencil_fft_3d_2d_mesh,
                Mesh(devs.reshape(2, n_devices // 2), ("py", "pz")),
                (None, "py", "pz")),
    }
    out = {}
    for name, (fn, mesh, spec) in cases.items():
        o, secs = timed(lambda a, b: fn(a, b, mesh, precision="float32"),
                        *_sharded(mesh, spec, re, im))
        _on_devices(o, n_devices, f"pencil 3d {name}")
        got = _as64(o)
        _finite(got, f"pencil 3d {name}")
        print(f"  {name}: {secs * 1e6:.1f} us per call")
        _gate(deviation(got, want), f"pencil 3d {name} vs oracle")
        rel = _rel(got[0] + 1j * got[1], ref)
        print(f"  {name} vs single-card jnp.fft.fftn: {rel:.3e} limit 1e-4")
        check(rel <= 1e-4, f"pencil 3d {name} disagrees with jnp.fft.fftn")
        out[name] = {"us": secs * 1e6, "rel_jnp": rel}
    return out


def phase_poisson(n: int, n_devices: int):
    """models.poisson_solve_3d (float32) against the same spectral solve by
    single-card jnp.fft.fftn and by fp64 NumPy: max |diff| <= 1e-4 max|u|."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tensorfft_tpu.models import poisson_solve_3d
    from tensorfft_tpu.models.poisson import _spectral_laplacian

    rng = np.random.default_rng(17)
    f64 = rng.standard_normal((n, n, n))
    f64 -= f64.mean()
    lam = _spectral_laplacian(n, n, n, (1.0, 1.0, 1.0), True)
    inv = 1.0 / lam
    inv[0, 0, 0] = 0.0
    u64 = np.real(np.fft.ifftn(np.fft.fftn(f64) * inv))
    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("sp",))
    f = f64.astype(np.float32)
    u, secs = timed(lambda a: poisson_solve_3d(a, mesh),
                    *_sharded(mesh, ("sp", None, None), f))
    _on_devices((u,), n_devices, "poisson_solve_3d")
    u = np.asarray(u, np.float64)
    _finite((u,), "poisson_solve_3d")
    ref = np.asarray(_single_card(
        lambda a, i: jnp.real(jnp.fft.ifftn(jnp.fft.fftn(a) * i)),
        f, inv.astype(np.float32)), np.float64)
    rel64 = _rel(u, u64)
    rel_jnp = _rel(u, ref)
    print(f"  {secs * 1e6:.1f} us per solve; vs fp64 NumPy {rel64:.3e} "
          f"limit 1e-4, vs single-card jnp.fft {rel_jnp:.3e} limit 1e-4")
    check(rel64 <= 1e-4 and rel_jnp <= 1e-4, "poisson_solve_3d disagrees")
    return {"us": secs * 1e6, "rel_fp64": rel64, "rel_jnp": rel_jnp}


ONE_CARD = (
    ("c2c bf16 N=16384 batch=4096",
     lambda: phase_c2c(16384, 4096, "bfloat16", memory=True)),
    ("c2c float32 N=4096 batch=4096 (max <= 1e-4)",
     lambda: phase_c2c(4096, 4096, "float32", max_limit=1e-4)),
    ("c2c bf16 N=2^20 batch=64", lambda: phase_c2c(1 << 20, 64, "bfloat16")),
    ("ifft(fft(x)) bf16 N=16384 batch=256",
     lambda: phase_roundtrip(16384, 256)),
    ("rfft/irfft float32 N=2^20 batch=16", lambda: phase_rfft(1 << 20, 16)),
    ("fft_convolve_2d float32 4096x4096", lambda: phase_conv2d(4096, 4096)),
)


def four_card_phases(n_devices: int = 4):
    return (
        ("batch_sharded_fft float32 N=16384 batch=4096",
         lambda: phase_batch_sharded(16384, 4096, n_devices)),
        ("pencil_fft_1d float32 N=2^24",
         lambda: phase_pencil_1d(1 << 24, n_devices)),
        ("pencil_fft_3d slab + 2x2 mesh float32 512^3",
         lambda: phase_pencil_3d(512, n_devices)),
        ("poisson_solve_3d float32 512^3",
         lambda: phase_poisson(512, n_devices)),
    )


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def run_phases(phases) -> dict:
    results, failed = {}, []
    for name, fn in phases:
        print(f"[phase] {name}", flush=True)
        t0 = time.perf_counter()
        try:
            results[name] = fn()
        except Exception as e:  # report every phase, then fail the run
            print(f"  FAILED: {type(e).__name__}: {e}", flush=True)
            failed.append(name)
        print(f"  phase wall {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        raise PhaseFailed(f"failed phases: {failed}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the distributed phases, on four cards")
    ap.add_argument("--out", default=None,
                    help="also write the phase results as JSON here")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {platform!r}",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2

    from tensorfft_tpu.utils import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}")
    print(f"jax {jax.__version__}; {len(devices)} x {devices[0].device_kind}")
    for n in (4096, 16384, 1 << 19, 1 << 20, 1 << 24):
        print(f"route N={n}: {tfft.route(n).value}")
    phases = four_card_phases(want) if args.four else ONE_CARD
    try:
        results = run_phases(phases)
    except PhaseFailed as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
