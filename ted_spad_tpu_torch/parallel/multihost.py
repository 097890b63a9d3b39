"""Process-group start-up and per-process input sharding (counterpart of
ted_spad_tpu/parallel/multihost.py).

One process drives one card. ``torchrun`` (``python -m torch.distributed.run``)
starts the processes and exports ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``MASTER_ADDR`` / ``MASTER_PORT``; ``initialize_distributed`` reads them and joins the
group. The default backend is NCCL; gloo runs only where the caller names it (the CPU,
or several ranks sharing one card). With no group every function here answers for a
single process, so stage code can call them unconditionally.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# Cluster-environment markers: the JAX package's list (coordinator env, TPU pod
# metadata, Slurm / OpenMPI launchers) and torchrun's variables. If any is set, a
# failed start-up is real, not a single-process development run.
CLUSTER_MARKERS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "TPU_WORKER_HOSTNAMES",
    "MEGASCALE_COORDINATOR_ADDRESS",
    "SLURM_JOB_NUM_NODES",
    "OMPI_COMM_WORLD_SIZE",
    "TORCHELASTIC_RUN_ID",
    "RANK",
    "WORLD_SIZE",
    "LOCAL_RANK",
    "MASTER_ADDR",
)

# How long a collective waits for the other ranks before it raises: a rank that died
# fails the run instead of hanging it.
DEFAULT_TIMEOUT_S = 600.0


def in_cluster() -> bool:
    """Whether any cluster marker is set in the environment."""
    return any(os.environ.get(k) for k in CLUSTER_MARKERS)


def initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    backend: str = "nccl",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    With no arguments the group is read from torchrun's environment (``env://``); a
    failure is swallowed only in the known single-process case (no cluster marker
    set), where the process stays a group of none. A process that should have found
    its group re-raises instead of silently running alone. With explicit arguments
    (``init_method`` such as ``tcp://localhost:PORT`` or ``file:///path``, the world
    size and this process's rank), failures always raise. A group that already exists
    is left as it is."""
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is None and world_size is None:
        try:
            dist.init_process_group(backend, init_method="env://", timeout=timeout)
        except Exception:  # noqa: BLE001
            if in_cluster():
                raise  # a misconfigured launcher must not pass as one process
            return  # known single-process development environment
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=timeout)


def initialize_single(*, backend: str = "nccl", timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """A group of one process (rank 0 of 1) over an in-memory store: what ``--mesh``
    joins when no launcher started the process. Raises when a cluster marker says the
    process belongs to a larger group, so that case never shrinks to one process."""
    if dist.is_initialized():
        return
    if in_cluster():
        raise RuntimeError("a cluster marker is set: join the launcher's group with "
                           "initialize_distributed(), not a group of one")
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=timeout_s))


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``; 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_device(device_type: str = "cuda") -> torch.device:
    """The card this process drives, ``cuda:LOCAL_RANK``; the CPU for ``"cpu"``."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device(device_type, local_rank())


def process_shard() -> tuple[int, int]:
    """(shard_id, num_shards) for per-process input sharding: feeds
    ``extract_features(shard_id=..., num_shards=...)`` and file-list splits (DALI's
    shard_id / num_shards, dali_extraction.py:63-64); (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_batch_slice(global_batch: int) -> int:
    """Per-process batch size of a global batch sharded over the processes."""
    n = process_shard()[1]
    assert global_batch % n == 0, f"global batch {global_batch} not divisible by {n} processes"
    return global_batch // n


def is_writer() -> bool:
    """Whether this process writes the run's files (checkpoints, metrics): rank 0 of
    the group, or the only process."""
    return process_shard()[0] == 0


# The gloo group of the host-side exchanges and barriers, set by
# ``mesh.data_parallel_mesh``; the default group until then.
_HOST_GROUP = None


def set_host_group(group) -> None:
    global _HOST_GROUP
    _HOST_GROUP = group


def barrier() -> None:
    """Wait for every process of the group (a no-op without one): a checkpoint that
    rank 0 wrote is on disk for every rank after it."""
    if dist.is_initialized():
        dist.barrier(group=_HOST_GROUP)
