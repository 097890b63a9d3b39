"""95th percentile, over every batch of the window, of the host-clock time from a
batch handed to the host-to-device copy to its features on the host. Exposes
stalls; it decides nothing."""

import numpy as np


def read(record: dict):
    times = record.get("batch_ms")
    if not times or len(times) < 20:
        return None
    return float(np.percentile(times, 95))
