"""Model FLOPs of the window's clips (fa over their frames, ft, and MGFN over
each scored video, counted on the float32 reference) over the window's seconds,
as a share of one H100's dense bf16 peak."""

from bench_port import counts


def read(record: dict):
    if not record.get("model_flops") or not record.get("window_s"):
        return None
    return 100.0 * record["model_flops"] / record["window_s"] / counts.BF16_FLOPS
