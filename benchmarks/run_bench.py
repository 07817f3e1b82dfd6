"""Throughput sweep over fft_length (FFTBenchSinlge.cu:10-44 analog [sic]).

Benchmarks the library across N (default 4096..2^22 like the reference's
bench range), writing BenchResults.dat.  Each row is the mean of
block_until_ready-bracketed calls after warm-up.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--start", type=int, default=4096)
    ap.add_argument("--end", type=int, default=1 << 22)
    ap.add_argument("--batch-elems", type=int, default=1 << 24,
                    help="total elements per measurement (batch = elems/N)")
    ap.add_argument("--precision", default="bfloat16")
    ap.add_argument("--samples", type=int, default=20,
                    help="timed calls per row after 3 warm-up calls")
    ap.add_argument("--out", default="BenchResults.dat",
                    help="output table path (BenchResults.dat format)")
    ap.add_argument("--baseline", default=None, choices=["staged", "xla"],
                    help="bench one strategy instead of the routed default "
                         "(the reference benches its baseline, cuFFT, at "
                         "every length as a separate driver — "
                         "CuFFTBenchSingle.cu:10-40)")
    args = ap.parse_args()

    import jax.numpy as jnp

    import tensorfft_tpu as tfft
    from tensorfft_tpu.fft import _fft_split_jit
    from tensorfft_tpu.testing.io import write_bench_table
    from tensorfft_tpu.testing.timer import measure
    from tensorfft_tpu.utils import enable_compile_cache

    enable_compile_cache()
    storage = tfft.Precision(args.precision).storage_dtype

    rows = []
    n = args.start
    while n <= args.end:
        batch = max(1, args.batch_elems // n)
        plan = tfft.create_plan(n, precision=args.precision,
                                strategy=args.baseline or "auto")
        rng = np.random.default_rng(0)
        re = jnp.asarray(rng.standard_normal((batch, n)), storage)
        im = jnp.asarray(rng.standard_normal((batch, n)), storage)
        r = measure(lambda a, b: _fft_split_jit(a, b, plan, True), (re, im),
                    warmup=3, samples=args.samples)
        t_ns = r.average_time_ns
        flops = 5.0 * n * float(np.log2(n)) * batch
        gflops = flops / t_ns
        rows.append({
            "fft_length": n, "batch": batch,
            "avg_time_us": t_ns / 1e3,
            "sigma_us": r.std_deviation_ns / 1e3,
            "gflops": gflops,
            "strategy": plan.resolve_strategy().value,
        })
        print(f"N={n:>9d} B={batch:>6d}: {t_ns/1e3:9.1f} us  "
              f"{gflops:8.1f} GFLOP/s  [{plan.resolve_strategy().value}]")
        n *= 2
    write_bench_table(args.out, rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
