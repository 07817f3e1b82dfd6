"""Accuracy vs input bandwidth (AccuracyTestBandwidth.cu:17-87 analog).

Fixed N (default 16^5 = 2^20, matching the reference), frequency cutoff swept
1..N by powers of two: measures how deviation grows with input spectral
occupancy.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--precision", default="bfloat16")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--baseline", action="store_true",
                    help="measure the staged float32 route instead (the "
                         "on-device AccuracyTestBandwidthCuFFT.cu:53-56 "
                         "analog)")
    ap.add_argument("--out", default="Accuracy_Bandwidth.dat")
    args = ap.parse_args()

    from tensorfft_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import tensorfft_tpu as tfft
    from tensorfft_tpu.testing import (
        deviation, fft_oracle, get_random_weights, sine_superposition,
    )
    from tensorfft_tpu.testing.io import write_accuracy_table

    if args.baseline:
        plan = tfft.create_plan(args.n, precision="float32", strategy="staged")
    else:
        plan = tfft.create_plan(args.n, precision=args.precision)
    rows = []
    cutoff = 1
    while cutoff <= args.n:
        w_re = get_random_weights(cutoff, args.seed)
        w_im = get_random_weights(cutoff, args.seed * args.seed)
        # Normalize amplitude so bandwidth, not energy, is the variable.
        scale = 1.0 / np.sqrt(max(cutoff, 1))
        re = sine_superposition(args.n, w_re * scale)
        im = sine_superposition(args.n, w_im * scale)
        o = tfft.fft_split(re, im, plan)
        d = deviation(
            (np.asarray(o[0], np.float64), np.asarray(o[1], np.float64)),
            fft_oracle(re, im),
        )
        rows.append({"fft_length": args.n, "cutoff": cutoff, "avg": d.average,
                     "sigma": d.sigma, "max": d.maximum})
        print(f"cutoff={cutoff:>9d}: {d}")
        cutoff *= 4
    write_accuracy_table(args.out, rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
