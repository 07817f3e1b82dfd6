"""Multi-chip execution: sharded batches and pencil-decomposed transforms.

The reference's multi-GPU support is dead code with zero inter-device
communication (ComputeFFT.h:295-557, DataHandler.h:168-403, fully commented
out).  This package supersedes it with real JAX sharding:

  * batch.py  — data parallelism: the batch axis sharded over a mesh
                (what the reference's per-GPU independent FFTs aspired to)
  * pencil.py — one transform sharded across devices: four-step/pencil
                decomposition whose global transposes are all_to_all
                collectives under shard_map (no analog in the reference;
                the config-5 extension)
"""

from tensorfft_tpu.parallel.batch import batch_sharded_fft, make_batch_mesh
from tensorfft_tpu.parallel.pencil import (
    pencil_fft_1d,
    pencil_fft_3d,
    pencil_fft_3d_2d_mesh,
)
