"""Data parallel over ``torch.distributed``, one process per card (counterpart of
ted_spad_tpu/parallel/). A step sharded over W ranks computes the one-process step,
as the JAX package's sharded steps compute their single-device ones: global
BatchNorm statistics, losses over the global rows, global microbatches and global
dropout masks (mesh.py says how)."""

from ted_spad_tpu_torch.parallel.mesh import (
    DataParallelMesh,
    active,
    active_mesh,
    data_parallel_mesh,
    pad_to_multiple,
)

__all__ = ["DataParallelMesh", "active", "active_mesh", "data_parallel_mesh", "pad_to_multiple"]
