"""Device peaks, roofline and overlap models, compile-cache setup."""

from tensorfft_tpu.utils.compile_cache import enable_compile_cache
from tensorfft_tpu.utils.device import (
    PEAKS,
    DeviceSpec,
    OverlapEstimate,
    all_to_all_seconds,
    device_spec,
    fft_roofline_seconds,
    overlap_estimate,
)
