"""Accuracy curve: deviation vs fft_length (AccuracyTest.cu:17-86 analog).

Sweeps N over powers of two, measuring avg/sigma/max deviation of the chosen
precision policy against the fp64 NumPy oracle on seeded sine-superposition
inputs (frequency cutoff 256, matching AccuracyTest.cu:22), writing
Accuracy_Test.dat (+ .json).  The XLA-fp32 comparison curve
(AccuracyTestCuFFT.cu analog) is produced with --baseline.

Runs on the GPU by default; on the CPU (JAX_PLATFORMS=cpu) the staged route
reproduces the same stage numerics via the explicit operand decompositions.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--start", type=int, default=256)
    ap.add_argument("--end", type=int, default=1 << 20)
    ap.add_argument("--precision", default="bfloat16")
    ap.add_argument("--cutoff", type=int, default=256)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--baseline", nargs="?", const="staged-f32", default=None,
                    choices=["staged-f32", "xla"],
                    help="measure a baseline instead (cuFFT-fp32 analog, "
                         "AccuracyTestCuFFT.cu:53-56): 'staged-f32' = the "
                         "staged route at float32 policy; 'xla' = jnp.fft "
                         "in complex64 (cuFFT on the GPU)")
    ap.add_argument("--tuning", default=None,
                    help="'auto' runs each length under its tuner-cache "
                         "winner (the shipping plan) instead of the default")
    ap.add_argument("--out", default="Accuracy_Test.dat")
    args = ap.parse_args()

    from tensorfft_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import tensorfft_tpu as tfft
    from tensorfft_tpu.testing import (
        deviation, fft_oracle, get_random_weights, sine_superposition,
    )
    from tensorfft_tpu.testing.io import write_accuracy_table
    from tensorfft_tpu.testing.oracle import xla_baseline

    w_re = get_random_weights(args.cutoff, args.seed)
    w_im = get_random_weights(args.cutoff, args.seed * args.seed)

    rows = []
    n = args.start
    while n <= args.end:
        re = sine_superposition(n, w_re)
        im = sine_superposition(n, w_im)
        want = fft_oracle(re, im)
        if args.baseline == "xla":
            got = xla_baseline(re, im)
        elif args.baseline == "staged-f32":
            plan = tfft.create_plan(n, precision="float32", strategy="staged")
            o = tfft.fft_split(re, im, plan)
            got = (np.asarray(o[0], np.float64), np.asarray(o[1], np.float64))
        else:
            plan = tfft.create_plan(n, precision=args.precision,
                                    tuning=args.tuning)
            o = tfft.fft_split(re, im, plan)
            got = (np.asarray(o[0], np.float64), np.asarray(o[1], np.float64))
        d = deviation(got, want)
        rows.append({"fft_length": n, "avg": d.average, "sigma": d.sigma,
                     "max": d.maximum})
        print(f"N={n:>9d}: {d}")
        n *= 2
    write_accuracy_table(args.out, rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
