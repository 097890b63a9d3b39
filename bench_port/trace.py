"""Reading a ``torch.profiler`` window: device busy time as the union of the kernels'
intervals (not their sum: kernels on several streams overlap), per-kernel totals, and
the device's idle gaps labelled by the benchmark's own ``record_function`` range that
was open on the host when each gap began."""

from __future__ import annotations

import bisect
import collections

LABEL_PREFIX = "bench."


def _device_events(events):
    """Kernels, copies and sets on the card; the profiler also puts each host range on
    the card's timeline, spanning its kernels, and those are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events if e.device_type == cuda and e.time_range.end > e.time_range.start
            and not e.name.startswith(LABEL_PREFIX)]


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float):
    """The idle (start, end) gaps of [start, end] that no interval covers."""
    out, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(s, e) for s, e in out if e > s]


def _label(ranges, starts, t: float) -> str:
    """The innermost benchmark range open at time t, or 'outside': among the ranges
    (sorted by start) that began by t, the latest-starting one still open. Ranges
    nest, so it is among the last few."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(ranges[max(0, i - 8):i]):
        if s <= t < e:
            return name
    return "outside"


WINDOW = "bench.window"


def read_window(prof, top: int = 10) -> dict:
    """{"busy_s", "window_s", "kernels": {name: [count, seconds]}, "device_ops",
    "idle_gaps"} of the profiled window: the span of the ``WINDOW`` range the cell
    opened around the traced work (closed after a synchronise)."""
    events = list(prof.events())
    marks = [e for e in events if e.name == WINDOW]
    if not marks:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    window_start_us, window_end_us = marks[0].time_range.start, marks[0].time_range.end
    dev = _device_events(events)
    spans = [(max(e.time_range.start, window_start_us), min(e.time_range.end, window_end_us))
             for e in dev]
    spans = [(s, e) for s, e in spans if e > s]
    kernels: dict = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        k = kernels[e.name]
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) * 1e-6
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.name.startswith(LABEL_PREFIX) and e.name != WINDOW)
    starts = [r[0] for r in ranges]
    idle: dict = collections.defaultdict(float)
    for s, e in gaps(spans, window_start_us, window_end_us):
        idle[_label(ranges, starts, s)] += (e - s) * 1e-6
    ops = sorted(((n, v[1]) for n, v in kernels.items()), key=lambda kv: -kv[1])[:top]
    return {"busy_s": union_us(spans) * 1e-6,
            "window_s": (window_end_us - window_start_us) * 1e-6,
            "kernels": {n: list(v) for n, v in kernels.items()},
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()), key=lambda kv: -kv[1])[:top]}
