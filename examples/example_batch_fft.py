"""Batched FFT (ExampleBatchFFT.cu:21-85 analog).

The reference demos 20 FFTs of N=4096 overlapped via one CUDA stream each
(ComputeFFT.h:166-208); here the batch is simply a leading axis of one
jitted transform.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import tensorfft_tpu as tfft
from tensorfft_tpu.testing import ScopeTimer, deviation, fft_oracle, make_test_signal


def main():
    fft_length, batch = 4096, 20
    res, ims = [], []
    for j in range(batch):
        re, im = make_test_signal(fft_length, 42 * j, 42 * 42 * j)
        res.append(re)
        ims.append(im)
    re = np.stack(res)
    im = np.stack(ims)

    plan = tfft.create_plan(fft_length)
    with ScopeTimer("batched fft (incl. compile)"):
        o_re, o_im = tfft.fft_split(re, im, plan)
        o_re.block_until_ready()

    worst = None
    for j in range(batch):
        d = deviation(
            (np.asarray(o_re[j], np.float64), np.asarray(o_im[j], np.float64)),
            fft_oracle(re[j], im[j]),
        )
        if worst is None or d.average > worst.average:
            worst = d
    print(f"batch={batch}, worst {worst} | gate:",
          "PASS" if worst.passes_reference_gate() else "FAIL")
    return 0


if __name__ == "__main__":
    sys.exit(main())
