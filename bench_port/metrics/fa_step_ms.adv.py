"""Mean time of one fa step of the adversarial loop, its ``augment_inputs`` included:
CUDA events around each fa call of the traced run."""


def read(record: dict):
    times = record.get("fa_ms")
    return sum(times) / len(times) if times else None
