"""Kernel K1 (ops/preprocess.py, csrc/preprocess.cu) against its byte bound: the
bytes its launches in the traced stretch need at the card's memory rate, over K1's
device time in the profiler's trace."""

from bench_port import counts
from bench_port.metrics_common import kernel_share


def read(record: dict):
    return kernel_share(record, "preprocess_kernel", "k1",
                        lambda n: n * record.get("k1_bytes_per_launch", 0) / counts.HBM_BYTES_PER_S)
