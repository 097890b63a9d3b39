"""Mean host-clock time to score one video, after the window's extraction as
``score_video`` scores after ``extract_features``: the magnitude channel, bucket
padding, the MGFN call and the frame scores on the host."""


def read(record: dict):
    times = record.get("score_ms")
    return sum(times) / len(times) if times else None
