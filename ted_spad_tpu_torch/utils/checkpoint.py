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
