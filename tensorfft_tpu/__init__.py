"""tensorfft_tpu — an FFT library in JAX / XLA for NVIDIA GPUs.

Built from scratch with the capabilities of CPestka/Tensor-FFT: half-precision
complex FFTs for power-of-two lengths, computed as Cooley-Tukey stages
expressed as DFT-matrix multiplies with fp32 accumulation, or through cuFFT
where that is faster; its launch-geometry planner becomes a pure-Python plan
that is a static jit argument, its stream-per-FFT batching becomes a leading
batch axis, and its dead multi-GPU code becomes real `jax.sharding`
data/pencil parallelism.  See SURVEY.md for the layer map.

Public API:
    create_plan, FFTPlan, Precision, Strategy   — planning (Plan.h analog)
    route                                       — strategy per platform/length
    fft, ifft, fft_split, ifft_split            — 1D C2C (ComputeFFT.h analog)
    rfft, irfft                                 — real transforms (extension)
    fft2, ifft2, fftn, ifftn                    — N-D (extension)
    plan_works_on_device                        — device check (Plan.h:257)
"""

from tensorfft_tpu.plan import (
    FFTPlan,
    Precision,
    Strategy,
    create_plan,
    plan_works_on_device,
    route,
)
from tensorfft_tpu.fft import (
    fft,
    ifft,
    fft_split,
    ifft_split,
    fft2,
    ifft2,
    fftn,
    ifftn,
    fftn_split,
    ifftn_split,
)
from tensorfft_tpu.rfft import (
    irfft,
    irfft_split,
    irfftn,
    irfftn_split,
    rfft,
    rfft_split,
    rfftn,
    rfftn_split,
)
from tensorfft_tpu.bluestein import (
    fft_any,
    fft_split_any,
    ifft_any,
    ifft_split_any,
)
from tensorfft_tpu.spectral import (
    fftfreq,
    fftshift,
    fftshift_split,
    ifftshift,
    ifftshift_split,
    rfftfreq,
    window,
)

__version__ = "0.1.0"

__all__ = [
    "FFTPlan",
    "Precision",
    "Strategy",
    "create_plan",
    "plan_works_on_device",
    "route",
    "fft",
    "ifft",
    "fft_split",
    "ifft_split",
    "fft2",
    "ifft2",
    "fftn",
    "ifftn",
    "fftn_split",
    "ifftn_split",
    "rfft",
    "irfft",
    "rfft_split",
    "irfft_split",
    "rfftn",
    "irfftn",
    "rfftn_split",
    "irfftn_split",
    "fft_any",
    "ifft_any",
    "fft_split_any",
    "ifft_split_any",
    "fftshift",
    "ifftshift",
    "fftshift_split",
    "ifftshift_split",
    "fftfreq",
    "rfftfreq",
    "window",
    "__version__",
]
