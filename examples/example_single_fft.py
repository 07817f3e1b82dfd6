"""Single large FFT, end to end (ExampleSingleFFT.cu:20-96 analog).

The reference demo computes one N=2^25 FFT with Mode_4096; here one N=2^22
half-precision FFT on the route plan.route picks (cuFFT on a GPU), verified
against the fp64 oracle.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import tensorfft_tpu as tfft
from tensorfft_tpu.testing import ScopeTimer, deviation, fft_oracle, make_test_signal


def main():
    fft_length = 1 << 22
    print(f"fft_length = {fft_length}")

    re, im = make_test_signal(fft_length, 42, 42 * 42)

    plan = tfft.create_plan(fft_length, precision="bfloat16")
    ok, why = tfft.plan_works_on_device(plan)
    if not ok:
        print("plan rejected:", why)
        return 1
    print(f"plan: strategy={plan.resolve_strategy().value} "
          f"radices={plan.radices}")

    with ScopeTimer("first call (incl. compile)"):
        o_re, o_im = tfft.fft_split(re, im, plan)
        o_re.block_until_ready()
    with ScopeTimer("second call"):
        o_re, o_im = tfft.fft_split(re, im, plan)
        o_re.block_until_ready()

    d = deviation(
        (np.asarray(o_re, np.float64), np.asarray(o_im, np.float64)),
        fft_oracle(re, im),
    )
    print(d, "| reference gate:", "PASS" if d.passes_reference_gate() else "FAIL")
    return 0


if __name__ == "__main__":
    sys.exit(main())
