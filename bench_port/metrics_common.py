"""Arithmetic shared by the per-layer metric readers."""

from __future__ import annotations

import sys


def kernel_share(record: dict, kernel: str, counter: str, bound_s) -> float | None:
    """A kernel's share of its roofline, in percent: ``bound_s(launches)``, the least
    time the traced stretch's launches need, over the kernel's device time in the
    trace. None where the trace holds no such kernel. The launches are the port
    wrapper's ``.launches`` counter over the stretch; a count that differs from the
    trace's is reported on standard error."""
    t = record.get("trace")
    if not t:
        return None
    found = [(n, c, s) for n, (c, s) in t["kernels"].items() if kernel in n]
    count = sum(c for _, c, _ in found)
    seconds = sum(s for _, _, s in found)
    if count == 0 or seconds <= 0:
        return None
    launches = record.get("launches", {}).get(counter)
    if launches != count:
        print(f"bench_port: {kernel}: {launches} launches counted, {count} in the trace",
              file=sys.stderr)
    bound = bound_s(launches)
    return 100.0 * bound / seconds if bound > 0 else None
