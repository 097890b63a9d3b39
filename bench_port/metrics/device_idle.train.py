"""Share of the traced stretch in which no kernel ran on the card: one minus the
union of the kernels' intervals over the stretch."""


def read(record: dict):
    t = record.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
