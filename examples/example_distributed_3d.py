"""Distributed 3D FFT + Poisson solve (the config-5 demo).

On several GPUs this runs the slab-decomposed 3D FFT with all_to_all
transposes over NVLink; without them run with
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
to execute the same collectives on a virtual 8-device mesh.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import jax
    from jax.sharding import Mesh

    from tensorfft_tpu.models import poisson_solve_3d
    from tensorfft_tpu.parallel import pencil_fft_3d

    devices = jax.devices()
    mesh = Mesh(np.asarray(devices), ("sp",))
    print(f"mesh: {len(devices)} x {devices[0].platform}")

    n = 64 if len(devices) > 1 else 32
    rng = np.random.default_rng(0)
    re = rng.standard_normal((n, n, n)).astype(np.float32)
    im = rng.standard_normal((n, n, n)).astype(np.float32)

    o_re, o_im = pencil_fft_3d(re, im, mesh, precision="float32")
    want = np.fft.fftn(re + 1j * im) / n**3
    got = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    print(f"3D FFT {n}^3 max err vs oracle: {np.abs(got - want).max():.3e}")

    f = rng.standard_normal((n, n, n)).astype(np.float32)
    f -= f.mean()
    u = np.asarray(poisson_solve_3d(f, mesh), np.float64)
    h2 = (1.0 / n) ** 2
    lap = sum(
        np.roll(u, s, a) for a in range(3) for s in (1, -1)
    ) - 6 * u
    resid = np.abs(lap / h2 - f).max()
    print(f"Poisson 7-point residual: {resid:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
