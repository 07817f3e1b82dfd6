"""Headline benchmark: batched half-precision 1D FFT throughput on one GPU.

    python bench.py            # one JSON line for the headline cell
    python bench.py --routes   # staged vs xla (cuFFT) at the route cells

Headline config = BASELINE.md row 1 (batch=4096, N=16384, bf16 storage); the
secondary N=4096 config is reported alongside in "secondary".  GFLOP/s uses
the standard 5*N*log2(N) complex-FFT flop convention (what cuFFT reports).
vs_baseline = speedup of the default plan over cuFFT, reached through
``jnp.fft`` in complex64 on the same card.  Times are means of
block_until_ready-bracketed calls after warm-up (testing.timer.measure); the
roofline share is against the card's published peaks (utils.device.PEAKS).

``--routes`` times both routes ``plan.route`` chooses between, staged and
xla, in bf16 and float32 at N = 4096 and 16384 (batch 4096) and at N = 2^20
(batch 64): the measurement behind the GPU route table in plan.py.

The script refuses any platform other than ``gpu``.
"""
import argparse
import json
import subprocess
import sys

import numpy as np

ROUTE_CELLS = ((4096, 4096), (16384, 4096), (1 << 20, 64))


def time_plan(plan, batch, samples=20):
    """(mean ns, sigma ns) of fft_split(plan) on a (batch, N) input."""
    import jax.numpy as jnp

    from tensorfft_tpu.fft import _fft_split_jit
    from tensorfft_tpu.testing.timer import measure

    rng = np.random.default_rng(0)
    storage = plan.precision.storage_dtype
    shape = (batch, plan.fft_length)
    re = jnp.asarray(rng.standard_normal(shape), storage)
    im = jnp.asarray(rng.standard_normal(shape), storage)
    r = measure(lambda a, b: _fft_split_jit(a, b, plan, True), (re, im),
                warmup=3, samples=samples)
    return r.average_time_ns, r.std_deviation_ns


def measure_config(n, batch, precision, samples=20):
    """One cell: the default plan, cuFFT (xla) and the staged route."""
    import jax.numpy as jnp

    import tensorfft_tpu as tfft
    from tensorfft_tpu.utils import fft_roofline_seconds

    plan = tfft.create_plan(n, precision=precision)
    t_plan, s_plan = time_plan(plan, batch, samples)
    times = {}
    for strategy in ("xla", "staged"):
        other = tfft.create_plan(n, precision=precision, strategy=strategy)
        times[strategy] = (t_plan if other.resolve_strategy()
                           is plan.resolve_strategy()
                           else time_plan(other, batch, samples)[0])
    flops = 5.0 * n * float(np.log2(n)) * batch
    itemsize = jnp.dtype(plan.precision.storage_dtype).itemsize
    roofline_s = fft_roofline_seconds(n, batch, plan.radices, itemsize)
    return {
        "n": n,
        "batch": batch,
        "precision": precision,
        "strategy": plan.resolve_strategy().value,
        "gflops": flops / t_plan,
        "time_us": t_plan / 1e3,
        "sigma_us": s_plan / 1e3,
        "baseline_time_us": times["xla"] / 1e3,
        "staged_time_us": times["staged"] / 1e3,
        "vs_baseline": times["xla"] / t_plan,
        "roofline_fraction": roofline_s / (t_plan / 1e9),
    }


def route_table(samples=20):
    import tensorfft_tpu as tfft

    rows = []
    for n, batch in ROUTE_CELLS:
        for precision in ("bfloat16", "float32"):
            row = {"n": n, "batch": batch, "precision": precision}
            for strategy in ("staged", "xla"):
                plan = tfft.create_plan(n, precision=precision,
                                        strategy=strategy)
                t, s = time_plan(plan, batch, samples)
                row[f"{strategy}_us"] = t / 1e3
                row[f"{strategy}_sigma_us"] = s / 1e3
            row["faster"] = ("staged" if row["staged_us"] < row["xla_us"]
                             else "xla")
            print(f"N={n:>8d} B={batch:>5d} {precision:>8s}: staged "
                  f"{row['staged_us']:.1f} us, xla {row['xla_us']:.1f} us "
                  f"-> {row['faster']}", flush=True)
            rows.append(row)
    return rows


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384,
                    help="headline transform length (BASELINE.md row 1)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--precision", default="bfloat16")
    ap.add_argument("--secondary-n", type=int, default=4096,
                    help="also-reported config; 0 disables")
    ap.add_argument("--routes", action="store_true",
                    help="time staged vs xla at the route cells instead")
    ap.add_argument("--samples", type=int, default=20)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    from tensorfft_tpu.utils import device_spec, enable_compile_cache

    enable_compile_cache()
    card = card_line()
    print(card)
    if args.routes:
        rows = route_table(args.samples)
        print(json.dumps({"routes": rows, "card": card,
                          "device_kind": devices[0].device_kind}))
        return 0

    spec = device_spec(devices[0])
    head = measure_config(args.n, args.batch, args.precision, args.samples)
    result = {
        "metric": "batched_1d_fft_throughput",
        "value": head["gflops"],
        "unit": "GFLOP/s",
        "vs_baseline": head["vs_baseline"],
        "baseline": "cuFFT via jnp.fft in complex64 on the same card",
        "config": {
            "n": head["n"], "batch": head["batch"],
            "precision": args.precision, "strategy": head["strategy"],
            "flop_convention": "5*N*log2(N) per transform",
        },
        "time_us": head["time_us"],
        "sigma_us": head["sigma_us"],
        "baseline_time_us": head["baseline_time_us"],
        "staged_time_us": head["staged_time_us"],
        "roofline_fraction": head["roofline_fraction"],
        "roofline_source": spec.source,
        "measurement": f"mean of {args.samples} block_until_ready calls "
                       "after 3 warm-up calls",
        "card": card,
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
    }
    if args.secondary_n:
        result["secondary"] = measure_config(
            args.secondary_n, args.batch, args.precision, args.samples)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
