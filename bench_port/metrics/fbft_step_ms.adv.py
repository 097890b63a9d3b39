"""Mean time of one fb/ft step of the adversarial loop, its ``augment_inputs``
included: CUDA events around each fb/ft call of the traced run."""


def read(record: dict):
    times = record.get("fbft_ms")
    return sum(times) / len(times) if times else None
