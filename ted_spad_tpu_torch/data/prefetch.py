"""Bounded background prefetch for host-side batch producers (counterpart of
ted_spad_tpu/data/prefetch.py).

A producer thread runs the generator up to ``depth`` items ahead, so loading the
feature files of batch N+1 overlaps the device work of batch N. Item order,
exceptions (raised at the consumer's ``next()``) and early termination
(``close()`` or leaving the ``with`` block stops the producer and closes the
source generator) are those of plain iteration.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Any, Iterable, Iterator

_DONE = object()


class PrefetchIterator:
    """Iterate ``source`` on a daemon thread, at most ``depth`` items ahead."""

    def __init__(self, source: Iterable[Any], depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, item: Any) -> None:
        # Bounded put that stays responsive to close(): never block forever on a
        # consumer that went away.
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _produce(self) -> None:
        it = iter(self._source)
        try:
            for item in it:
                self._put(item)
                if self._stop.is_set():
                    break
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            self._error = e
        finally:
            close = getattr(it, "close", None)
            if close is not None:  # run the generator's finalizers (files, pools)
                try:
                    close()
                except Exception:  # noqa: BLE001 — the consumer already has its items
                    pass
            self._put(_DONE)

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _DONE:
            self._stop.set()
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer (idempotent), also in the middle of iteration; the
        source generator's ``close()`` runs on the producer thread."""
        self._stop.set()
        try:  # unblock a producer waiting on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            print("PrefetchIterator.close(): producer still inside the source after 30s; "
                  "it will exit after its current item (daemon thread).", file=sys.stderr)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self._stop.set()


def prefetch(source: Iterable[Any], depth: int = 2) -> PrefetchIterator:
    """Wrap a batch generator so that it runs ``depth`` items ahead on a background
    thread; ``close()`` or the context manager stops it early without leaking the
    thread."""
    return PrefetchIterator(source, depth=depth)
