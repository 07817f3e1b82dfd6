"""Conformance runner (UnitTest.cu analog, the reference's gate executable).

Runs the full reference sweep (N=256..16^5, 10 seeded inputs each, thresholds
avg 1e-3 / sigma 1e-2 / max 0.5) on the current backend; exits nonzero on the
first failure, prints "All tests passed!" otherwise.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--start", type=int, default=256)
    ap.add_argument("--end", type=int, default=16 ** 5)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--precision", default="bfloat16")
    ap.add_argument("--run-offset", type=int, default=0,
                    help="start seed index (one-seed-per-process tail runs)")
    ap.add_argument("--tuning", default=None,
                    help="'auto' sweeps each length under its tuner-cache "
                         "winner instead of the default plan")
    args = ap.parse_args()

    from tensorfft_tpu.utils import enable_compile_cache

    enable_compile_cache()
    from tensorfft_tpu.testing.conformance import run_unit_sweep

    ok = run_unit_sweep(
        start_fft_length=args.start,
        end_fft_length=args.end,
        runs_per_fft_length=args.runs,
        precision=args.precision,
        tuning=args.tuning,
        run_offset=args.run_offset,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
