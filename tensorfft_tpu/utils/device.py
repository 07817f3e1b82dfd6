"""Device peaks and the models built on them.

Counterpart of the reference's device interrogation
(PlanWorksOnDevice/GetMaxNoOptInSharedMem, Plan.h:257-303, built on
cudaGetDeviceProperties): one table of published peaks keyed by JAX's
``device_kind``, used by the benchmark roofline and by the communication /
compute overlap model of the distributed paths.  A device missing from the
table is an error, never a default.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "DeviceSpec",
    "OverlapEstimate",
    "PEAKS",
    "VIRTUAL_CPU_MESH",
    "all_to_all_seconds",
    "device_spec",
    "fft_roofline_seconds",
    "overlap_estimate",
]


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    platform: str
    kind: str                  # jax Device.device_kind
    bf16_flops: float          # dense bf16 tensor-core peak, FLOP/s
    hbm_bandwidth: float       # device memory, bytes/s
    link_bandwidth: float      # to the other devices, one direction, bytes/s
    source: str


H100_SXM = DeviceSpec(
    "gpu", "NVIDIA H100 80GB HBM3",
    bf16_flops=989e12, hbm_bandwidth=3.35e12, link_bandwidth=450e9,
    source="NVIDIA H100 data sheet, SXM5, dense (no sparsity), 700 W power "
           "limit; NVLink 900 GB/s total = 450 GB/s each way",
)

# Published peaks, keyed by device_kind.
PEAKS = {spec.kind: spec for spec in (H100_SXM,)}

# Input of the overlap model when the distributed paths run on virtual CPU
# test meshes.  Not a peak of any device: it only keeps the 'auto' overlap
# choice computable where there is no card.
VIRTUAL_CPU_MESH = DeviceSpec(
    "cpu", "virtual CPU test mesh",
    bf16_flops=1e12, hbm_bandwidth=100e9, link_bandwidth=10e9,
    source="placeholder for virtual CPU test meshes; not a measurement",
)


def device_spec(device=None) -> DeviceSpec:
    """Peaks of ``device`` (default: the first JAX device).

    GPUs are looked up by ``device_kind`` in :data:`PEAKS`; an unknown kind
    raises.  A CPU device gets :data:`VIRTUAL_CPU_MESH`.
    """
    import jax

    if device is None:
        device = jax.devices()[0]
    platform = getattr(device, "platform", "cpu")
    if platform == "cpu":
        return VIRTUAL_CPU_MESH
    kind = getattr(device, "device_kind", "")
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r} "
            f"(platform {platform!r}); known kinds: {sorted(PEAKS)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class OverlapEstimate:
    """Predicted timing of one pipelined global-transpose + compute phase."""

    comm_seconds: float        # full all_to_all wall time, no overlap
    compute_seconds: float     # full per-pencil compute time, no overlap
    serial_seconds: float      # comm + compute, overlap=1
    overlapped_seconds: float  # with the recommended chunk count
    chunks: int                # recommended overlap chunk count (1 = off)

    @property
    def speedup(self) -> float:
        return self.serial_seconds / self.overlapped_seconds


def all_to_all_seconds(
    local_bytes: int, n_devices: int, spec: DeviceSpec | None = None,
    efficiency: float = 0.8,
) -> float:
    """Link roofline for one all_to_all over ``n_devices`` devices.

    Each device sends (P-1)/P of its local shard to the others over its
    one-direction link bandwidth (NVLink reaches every card of a host at the
    same rate); ``efficiency`` derates for protocol overhead (assumed, not
    measured).
    """
    if spec is None:
        spec = device_spec()
    if n_devices <= 1:
        return 0.0
    out_bytes = local_bytes * (n_devices - 1) / n_devices
    return out_bytes / (spec.link_bandwidth * efficiency)


def overlap_estimate(
    local_bytes: int,
    n_devices: int,
    compute_seconds: float,
    max_chunks: int = 8,
    spec: DeviceSpec | None = None,
    efficiency: float = 0.8,
) -> OverlapEstimate:
    """Predict whether software-pipelining a global transpose pays off.

    Models the parallel.pencil ``overlap=`` schedule: the shard is cut into
    ``c`` chunks; chunk i's all_to_all runs while chunk i-1 computes, so

        t(c) ~ max(t_comm, t_compute) + min(t_comm, t_compute) / c

    plus a per-collective latency floor (5 us assumed), which caps useful
    chunk counts.  Returns the best c in 1..max_chunks (powers of two) under
    this model.
    """
    if spec is None:
        spec = device_spec()
    latency_floor = 5e-6
    t_comm = all_to_all_seconds(local_bytes, n_devices, spec,
                                efficiency=efficiency)
    serial = t_comm + compute_seconds
    best_c, best_t = 1, serial
    c = 2
    while c <= max_chunks:
        # 2-stage pipeline bound: the dominant side runs back-to-back while
        # the other side hides behind it except for one exposed fill chunk.
        hi = max(t_comm, compute_seconds)
        lo = min(t_comm, compute_seconds)
        t = hi + lo / c + c * latency_floor
        if t < best_t:
            best_c, best_t = c, t
        c *= 2
    return OverlapEstimate(
        comm_seconds=t_comm,
        compute_seconds=compute_seconds,
        serial_seconds=serial,
        overlapped_seconds=best_t,
        chunks=best_c,
    )


def fft_roofline_seconds(
    n: int,
    batch: int,
    radices,
    itemsize: int,
    spec: DeviceSpec | None = None,
    passes: int = 1,
) -> float:
    """Speed-of-light wall time for a batched FFT on one device.

    max(memory bound, tensor bound): memory = read + write both planes once
    per pass; tensor = the staged path's stage products, 8*R real flops per
    complex point for each radix-R stage, at the bf16 peak.
    """
    if spec is None:
        spec = device_spec()
    mem_s = passes * 2 * 2 * n * batch * itemsize / spec.hbm_bandwidth
    flops = sum(8 * r * n * batch for r in radices)
    return max(mem_s, flops / spec.bf16_flops)
