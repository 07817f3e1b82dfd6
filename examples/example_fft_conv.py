"""FFT convolution demo (BASELINE.md config 3/4 applications).

Blurs an image by circular 2D convolution with a Gaussian kernel via the
convolution theorem (ifft2(fft2(img) * fft2(ker))), and cross-correlates two
real 1D signals through the R2C/C2R pair — the two application models the
reference lacks entirely (its scope ends at the transform itself,
ExampleSingleFFT.cu:20-96).  Runs on the GPU by default, or on the host
with ``JAX_PLATFORMS=cpu``.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tensorfft_tpu.models import fft_convolve_2d, fft_convolve_real
from tensorfft_tpu.testing import ScopeTimer


def main():
    # --- 2D: Gaussian blur of a synthetic image (row-column fft2 path) ---
    h = w = 512
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    image = (np.sin(2 * np.pi * xx / 64) * np.cos(2 * np.pi * yy / 96)
             + 0.1 * np.random.default_rng(0).standard_normal((h, w))
             ).astype(np.float32)
    sigma = 3.0
    gy = np.exp(-0.5 * (np.minimum(yy, h - yy) / sigma) ** 2)
    gx = np.exp(-0.5 * (np.minimum(xx, w - xx) / sigma) ** 2)
    kernel = (gy * gx).astype(np.float32)
    kernel /= kernel.sum()

    with ScopeTimer("fft_convolve_2d 512x512"):
        blurred = np.asarray(fft_convolve_2d(image, kernel))

    ref = np.real(np.fft.ifft2(np.fft.fft2(image) * np.fft.fft2(kernel)))
    err = np.max(np.abs(blurred - ref)) / np.max(np.abs(ref))
    print(f"2D blur: max rel err vs numpy fp64 = {err:.3e}")

    # --- 1D: circular cross-correlation of two real signals (R2C/C2R) ---
    n = 1 << 14
    rng = np.random.default_rng(1)
    sig = rng.standard_normal(n).astype(np.float32)
    shift = 777
    delayed = np.roll(sig, shift) + 0.05 * rng.standard_normal(n).astype(
        np.float32)
    # correlation(a, b) = conv(a, reversed(b)) for circular signals
    with ScopeTimer("fft_convolve_real 2^14"):
        corr = np.asarray(fft_convolve_real(delayed, sig[::-1].copy()))
    # conv with reversed b gives corr at index (k-1) mod n
    est = (int(np.argmax(corr)) + 1) % n
    print(f"1D correlation: true shift {shift}, estimated {est}, "
          f"{'OK' if est == shift else 'MISMATCH'}")


if __name__ == "__main__":
    main()
