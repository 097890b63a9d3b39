"""Mean time of one extraction step (``make_extract_step`` on a 16-clip batch):
CUDA events around every step call of the traced run."""


def read(record: dict):
    times = record.get("step_ms")
    return sum(times) / len(times) if times else None
