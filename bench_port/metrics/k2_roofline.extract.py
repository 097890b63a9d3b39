"""Kernel K2 (ops/doubleconv.py, csrc/doubleconv.cu) against its operation bound:
the operations of its launches in the traced stretch at the card's dense bf16
rate, over K2's device time in the profiler's trace."""

from bench_port import counts
from bench_port.metrics_common import kernel_share


def read(record: dict):
    return kernel_share(record, "double_conv_bf16", "k2",
                        lambda n: n * record.get("k2_flops_per_launch", 0) / counts.BF16_FLOPS)
