"""Run-scoped metrics logging, step timing and profiler traces (counterpart of
ted_spad_tpu/utils/logging.py). :class:`MetricsWriter` appends JSONL scalars to
``<log_dir>/<run_id>/metrics.jsonl`` and mirrors them to tensorboardX where that
package is installed, as the reference logs them (mgfn main.py:46, 97-102);
:func:`config_dump` writes a run's configuration beside them. Under data parallel
only rank 0 writes them. :func:`profile_trace` captures a Chrome trace of a block."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Any


class MetricsWriter:
    def __init__(self, log_dir: str, run_id: str):
        from ted_spad_tpu_torch.parallel.multihost import is_writer

        self.dir = os.path.join(log_dir, run_id)
        self._f = self._tb = None
        if not is_writer():
            return
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        try:  # optional mirror; the JSONL file is the record
            from tensorboardX import SummaryWriter  # type: ignore
        except ImportError:
            return
        self._tb = SummaryWriter(self.dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        # NaN ("no measurement this epoch") is written to the JSONL file but not to
        # tensorboardX, which warns on every non-finite value and plots nothing.
        if self._f is None:
            return
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                  "ts": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None and math.isfinite(float(value)):
            self._tb.add_scalar(tag, value, step)

    def scalars(self, values: dict[str, float], step: int) -> None:
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def text(self, tag: str, content: str) -> None:
        if self._f is None:
            return
        with open(os.path.join(self.dir, f"{tag}.txt"), "w") as f:
            f.write(content)

    def close(self) -> None:
        if self._f is None:
            return
        self._f.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """``with profile_trace('logs/run'): step()`` -> a Chrome trace of the block under
    ``log_dir`` (``<host>_<pid>.<ns>.pt.trace.json``; Perfetto or chrome://tracing
    open it): ``torch.profiler`` with CPU activity, and CUDA activity (the card's
    kernels and copies) when a card is in use. With ``enabled=False`` it records and
    writes nothing. Synchronize the card before the block ends, so its last kernels
    are in the trace."""
    if not enabled:
        yield
        return
    import socket

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"))


class StepTimer:
    """Rolling step timing on the host clock; ``rate(n_items)`` -> items/s over the
    window. Time device work with it only after a synchronize."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    def mean_step_s(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    def rate(self, items_per_step: int = 1) -> float:
        m = self.mean_step_s()
        return items_per_step / m if m > 0 else 0.0


def config_dump(writer: MetricsWriter, params: Any) -> None:
    """The run's configuration as text, one ``field: value`` line per dataclass field,
    in ``<run dir>/config.txt`` (mgfn main.py:21-27 save_config)."""
    if dataclasses.is_dataclass(params):
        content = "\n".join(f"{f.name}: {getattr(params, f.name)}" for f in dataclasses.fields(params))
    else:
        content = str(params)
    writer.text("config", content)
