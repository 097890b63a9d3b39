"""Checkpoint I/O in the JAX package's format (counterpart of
ted_spad_tpu/utils/checkpoint.py): one flax-msgpack file per checkpoint holding a
dict of named trees, e.g. ``{"mgfn_model_state_dict": {"params": ..., "batch_stats":
...}, "epoch": 3, "metric": 0.81}``. The bytes are flax's (utils/msgpack_codec.py),
so either package reads what the other writes; ``utils.jax_weights`` maps such a
tree onto a module and back.

Semantics kept from the JAX package: atomic writes (``.tmp`` then ``os.replace``),
a background writer whose host snapshot is taken on the caller, same-path saves that
supersede a queued one, best-metric gated saves named
``{name}_{epoch}_best_{metric:.4f}.ckpt`` (or, with a threshold, every epoch past
it), and a rolling ``{name}_temp.ckpt``.

Under data parallel rank 0 alone writes (every rank holds the same weights, so the
files are those of a one-process run; the other ranks' saves return the path and
write nothing), and ``load_checkpoint`` waits for every rank at a barrier first.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Mapping

import numpy as np
import torch

from ted_spad_tpu_torch.parallel import multihost
from ted_spad_tpu_torch.utils import msgpack_codec


def snapshot(tree: Any) -> Any:
    """A host copy of ``tree`` that later in-place updates of its tensors or arrays
    cannot reach: tensors to numpy (bfloat16 ones stay CPU tensors), every array
    copied. On the CPU ``Tensor.numpy()`` shares memory, hence the explicit copies."""
    if isinstance(tree, Mapping):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [snapshot(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def _write_atomic(path: str, state: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = msgpack_codec.serialize(state)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_checkpoint(path: str, payload: Mapping[str, Any]) -> str:
    """Atomically write a dict of named trees (rank 0 only); returns ``path``."""
    if multihost.is_writer():
        _write_atomic(path, snapshot(payload))
    return path


class AsyncCheckpointWriter:
    """Background writer: ``save`` snapshots the payload to host memory on the
    caller (a later ``optimizer.step()`` updates the parameters in place), and a
    worker thread serializes and writes it. Saves to a path already queued
    supersede the queued payload; at most ``max_pending`` distinct paths queue
    before ``save`` blocks. ``flush`` drains the queue and re-raises the first
    worker error. An atexit hook drains what is queued when the process exits."""

    def __init__(self, max_pending: int = 2):
        import atexit

        self._lock = threading.Condition()
        self._pending: dict[str, Any] = {}
        self._order: list[str] = []
        self._max_pending = max_pending
        self._inflight = 0
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        atexit.register(self._drain_at_exit)

    def save(self, path: str, payload: Mapping[str, Any]) -> str:
        if not multihost.is_writer():
            return path
        state = snapshot(payload)
        with self._lock:
            while path not in self._pending and len(self._order) >= self._max_pending:
                self._lock.wait()
            if path not in self._pending:
                self._order.append(path)
            self._pending[path] = state
            self._lock.notify_all()
        return path

    def _drain_at_exit(self) -> None:
        try:
            self.flush()
        except Exception as e:  # noqa: BLE001 — exit path: report, do not raise
            import sys

            print(f"AsyncCheckpointWriter: checkpoint write failed: {e!r}", file=sys.stderr)

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._order:
                    self._lock.wait()
                path = self._order.pop(0)
                state = self._pending.pop(path)
                self._inflight += 1
                self._lock.notify_all()  # a queue slot freed: unblock a waiting save()
            try:
                _write_atomic(path, state)
            except Exception as e:  # noqa: BLE001 — surfaced at flush()
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                with self._lock:
                    self._inflight -= 1
                    self._lock.notify_all()

    def flush(self) -> None:
        with self._lock:
            while self._order or self._inflight:
                self._lock.wait()
            if self._error is not None:
                err, self._error = self._error, None
                raise err


_async_writer: AsyncCheckpointWriter | None = None
_async_writer_lock = threading.Lock()


def async_writer() -> AsyncCheckpointWriter:
    """The process's background checkpoint writer, started at first use."""
    global _async_writer
    with _async_writer_lock:
        if _async_writer is None:
            _async_writer = AsyncCheckpointWriter()
        return _async_writer


def flush_checkpoints() -> None:
    """Drain pending background saves (a no-op if none were made)."""
    with _async_writer_lock:
        w = _async_writer
    if w is not None:
        w.flush()


def load_checkpoint(path: str) -> dict[str, Any]:
    """The dict of named trees in ``path`` (numpy leaves; bfloat16 ones as tensors)."""
    flush_checkpoints()  # read-after-write in one process: drain pending saves first
    multihost.barrier()  # ... and rank 0's, under data parallel
    with open(path, "rb") as f:
        return msgpack_codec.restore(f.read())


class BestCheckpointer:
    """Best-metric gated saving: a checkpoint for every strict improvement. With a
    ``threshold``, every epoch past it is saved instead (the anonymizer writes one
    for each validation above its accuracy threshold, train_anonymizer.py:511-525).
    ``best_path`` tracks the best one either way."""

    def __init__(self, directory: str, name: str, mode: str = "max",
                 threshold: float | None = None):
        self.directory = directory
        self.name = name
        self.mode = mode
        self.threshold = threshold
        self.best: float | None = None
        self.best_path: str | None = None

    def _beats(self, value: float, ref: float) -> bool:
        return value > ref if self.mode == "max" else value < ref

    def is_better(self, value: float) -> bool:
        if self.threshold is not None:
            return self._beats(value, self.threshold)
        return self.best is None or self._beats(value, self.best)

    def maybe_save(self, value: float, epoch: int, payload: Mapping[str, Any]) -> str | None:
        if not self.is_better(value):
            return None
        path = os.path.join(self.directory, f"{self.name}_{epoch}_best_{value:.4f}.ckpt")
        saved = async_writer().save(path, {**payload, "epoch": int(epoch), "metric": float(value)})
        if self.best is None or self._beats(value, self.best):
            self.best = value
            self.best_path = saved
        return saved


def save_temp(directory: str, name: str, payload: Mapping[str, Any]) -> str:
    """Rolling per-epoch checkpoint ``{name}_temp.ckpt``, written in the background."""
    return async_writer().save(os.path.join(directory, f"{name}_temp.ckpt"), payload)


# ---------------------------------------------------------------------------
# The asynchronous backend over torch.distributed.checkpoint (DCP): the counterpart
# of the JAX package's orbax backend. A checkpoint is a directory (DCP's ``.metadata``
# and one ``.distcp`` file per writing rank). The msgpack format above stays the
# canonical artifact; no stage calls this backend, as no stage of the JAX package
# calls orbax's.
# ---------------------------------------------------------------------------


class DcpCheckpointer:
    """Non-blocking saves over ``torch.distributed.checkpoint.async_save``.

    ``save`` returns once the payload is copied to host memory (DCP's stager copies
    every tensor on the caller, so a later ``optimizer.step()`` cannot reach what is
    written); the write runs on DCP's thread into ``<path>.tmp-<n>``, and a worker of
    this object then moves it to ``path``, replacing a checkpoint there (orbax's
    ``force=True``), in the order the saves were made. ``wait`` drains the pending saves
    and re-raises the first error (orbax's ``wait_until_finished``).

    Under a process group every rank calls ``save``, ``wait`` and ``load`` in the same
    order (the temporary names are counted, not drawn); DCP's planner writes a tensor
    that every rank holds once, and rank 0 moves the directory. DCP coordinates over a
    group that runs on the CPU: the default group if its backend includes gloo, else a
    gloo group made here (so every rank must create the checkpointer). With no group
    it works in one process."""

    def __init__(self):
        import concurrent.futures
        import torch.distributed as dist

        self._group = None
        if dist.is_available() and dist.is_initialized() and "gloo" not in str(dist.get_backend()):
            self._group = dist.new_group(backend="gloo")
        self._worker = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list = []
        self._count = 0

    @staticmethod
    def _distributed() -> bool:
        import torch.distributed as dist

        return dist.is_available() and dist.is_initialized()

    def save(self, path: str, payload: Mapping[str, Any]) -> str:
        import torch.distributed.checkpoint as dcp

        path = os.path.abspath(path)
        tmp = f"{path}.tmp-{self._count}"
        self._count += 1
        os.makedirs(os.path.dirname(path), exist_ok=True)
        writes = dcp.async_save(_dcp_tree(dict(payload)),
                                storage_writer=dcp.FileSystemWriter(tmp),
                                process_group=self._group)
        self._pending.append(self._worker.submit(self._land, writes, tmp, path))
        return path

    def _land(self, writes, tmp: str, path: str) -> None:
        import shutil

        writer = not self._distributed() or multihost.is_writer()
        try:
            writes.result()
        except BaseException:  # a failed save leaves no partial directory; re-raised
            if writer:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        if writer:
            old = f"{tmp}.old"
            if os.path.exists(path):
                os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)

    def wait(self) -> None:
        import torch.distributed as dist
        from torch.distributed.checkpoint import CheckpointException  # a BaseException

        pending, self._pending = self._pending, []
        error = None
        for job in pending:
            try:
                job.result()
            except (Exception, CheckpointException) as e:  # noqa: BLE001 -- the first is re-raised below
                error = error or e
        if self._distributed():
            dist.barrier(group=self._group)  # rank 0 has moved every directory
        if error is not None:
            raise error

    def load(self, path: str, template: Any | None = None,
             device: str | torch.device = "cpu") -> Any:
        import torch.distributed.checkpoint as dcp

        path = os.path.abspath(path)
        reader = dcp.FileSystemReader(path)
        if template is not None:
            target = _dcp_target(template)
            dcp.load(target, storage_reader=reader, process_group=self._group)
            return _dcp_like(template, target)
        metadata = reader.read_metadata()
        flat = {}
        for key, meta in metadata.state_dict_metadata.items():
            flat[key] = (torch.empty(tuple(meta.size), dtype=meta.properties.dtype, device=device)
                         if hasattr(meta, "size") else None)
        dcp.load(flat, storage_reader=dcp.FileSystemReader(path), process_group=self._group)
        return _dcp_unflatten(flat, metadata.planner_data)


def _dcp_tree(tree: Any) -> Any:
    """``tree`` with numpy arrays as tensors sharing their memory (DCP's stager copies
    them on the caller) and tuples kept as leaves."""
    if isinstance(tree, Mapping):
        return {k: _dcp_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_dcp_tree(v) for v in tree]
    if isinstance(tree, np.ndarray):  # ascontiguousarray would make a 0-d array 1-d
        return torch.from_numpy(tree if tree.flags.c_contiguous else tree.copy(order="C"))
    return tree


def _dcp_target(template: Any) -> Any:
    """A fresh tree of ``template``'s structure for ``dcp.load`` to fill: tensors
    empty on the template's device and in its dtype, numpy arrays as CPU tensors,
    every other leaf a copy (DCP replaces it)."""
    if isinstance(template, Mapping):
        return {k: _dcp_target(v) for k, v in template.items()}
    if isinstance(template, list):
        return [_dcp_target(v) for v in template]
    if isinstance(template, torch.Tensor):
        return torch.empty_like(template)
    if isinstance(template, np.ndarray):
        return torch.empty(template.shape, dtype=torch.from_numpy(np.empty(0, template.dtype)).dtype)
    return template


def _dcp_like(template: Any, loaded: Any) -> Any:
    """``loaded`` with the template's numpy leaves back as numpy arrays."""
    if isinstance(template, Mapping):
        return {k: _dcp_like(v, loaded[k]) for k, v in template.items()}
    if isinstance(template, list):
        return [_dcp_like(v, x) for v, x in zip(template, loaded)]
    if isinstance(template, np.ndarray):
        return loaded.numpy()
    return loaded


def _dcp_unflatten(flat: dict, paths: Mapping[str, tuple]) -> dict:
    """The nested dicts and lists that DCP's planner flattened into ``flat`` (its
    ``planner_data`` maps each key to its path: strings for dict keys, ints for list
    positions)."""
    root: dict = {}
    for key, value in flat.items():
        path = paths[key]
        node: Any = root
        for part, nxt in zip(path[:-1], path[1:]):
            child = [] if isinstance(nxt, int) else {}
            if isinstance(node, list):
                while len(node) <= part:
                    node.append(None)
                node[part] = node[part] if node[part] is not None else child
                node = node[part]
            else:
                node = node.setdefault(part, child)
        if isinstance(node, list):
            while len(node) <= path[-1]:
                node.append(None)
        node[path[-1]] = value
    return root


def dcp_checkpointer() -> DcpCheckpointer:
    """An asynchronous checkpointer over DCP (counterpart of the JAX package's
    ``orbax_checkpointer``). DCP ships with torch, so unlike orbax's there is no
    ``None`` for a missing library; under a process group every rank creates it."""
    return DcpCheckpointer()


def save_checkpoint_dcp(checkpointer: DcpCheckpointer, path: str, payload: Mapping[str, Any]) -> str:
    """Non-blocking save of a dict of named trees as the DCP directory ``path``
    (counterpart of ``save_checkpoint_orbax``): tensors, numpy arrays (written as
    tensors), ints, floats and optimizer ``state_dict()``s; ``checkpointer.wait()``
    drains it. Returns ``path``."""
    return checkpointer.save(path, payload)


def load_checkpoint_dcp(checkpointer: DcpCheckpointer, path: str, template: Any | None = None,
                        device: str | torch.device = "cpu") -> Any:
    """The dict saved at ``path`` (counterpart of ``load_checkpoint_orbax``).

    With a ``template`` (orbax's ``StandardRestore(template)``) the result has its
    structure: tensors in its tensors' dtypes and on their devices, numpy arrays where
    it holds numpy arrays, int keys where it has them; the template is not changed.
    Without one the structure comes from the checkpoint's metadata: tensors (numpy
    arrays saved as tensors) on ``device``, dict keys as strings (an optimizer's
    ``state`` keys included, as in the msgpack format), other leaves as saved."""
    checkpointer.wait()  # read-after-write in one process: land pending saves first
    return checkpointer.load(path, template, device)
