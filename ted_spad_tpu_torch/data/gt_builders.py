"""Frame-level ground truth of the anomaly benchmarks (counterpart of
ted_spad_tpu/data/gt_builders.py; reference anomaly_detection_mgfn/data/
make_gt_{ucf,sh,xd}.py). Host-side numpy over parsed annotations.

- UCF-Crime: 1-2 inclusive [start, end] events per abnormal video from its temporal
  ``.mat``; num_frames = num_clips * 32; an event past the end is written as
  [start, end) and the trailing normal span skipped; a positive remainder under 64
  is trimmed.
- ShanghaiTech: per-video frame masks taken at stride 2, then padded with the last
  value to num_clips * 16.
- XD-Violence: "name s1 e1 s2 e2 ..." lines of exclusive spans; num_frames =
  num_clips * 32; a positive remainder under 16 is trimmed.
"""

from __future__ import annotations

import numpy as np


def ucf_video_gt(num_frames: int, events: list[tuple[int, int]] | None) -> np.ndarray:
    """One UCF video's frame labels from up to two inclusive (start, end) events,
    or zeros for a normal video (``events`` None or empty)."""
    if not events:
        return np.zeros(num_frames, dtype=float)
    gt: list[float] = []
    cursor = 0
    for start, end in events:
        gt.extend([0.0] * (start - cursor))
        if end + 1 > num_frames:
            gt.extend([1.0] * (end - start))
            return _trim(np.asarray(gt, dtype=float), num_frames, max_fix=64)
        gt.extend([1.0] * (end + 1 - start))
        cursor = end + 1
    gt.extend([0.0] * (num_frames - cursor))
    return _trim(np.asarray(gt, dtype=float), num_frames, max_fix=64)


def shanghai_video_gt(num_frames: int, frame_mask: np.ndarray | None) -> np.ndarray:
    """One ShanghaiTech video's labels: the mask at stride 2, padded with its last
    value to ``num_frames``; zeros for a normal video."""
    if frame_mask is None:
        return np.zeros(num_frames, dtype=float)
    anno = np.asarray(frame_mask)[::2].astype(float)
    if len(anno) < num_frames:
        anno = np.concatenate([anno, np.full(num_frames - len(anno), anno[-1])])
    if len(anno) != num_frames:
        raise ValueError(f"frame mask length {len(anno)} != expected {num_frames}")
    return anno


def xd_video_gt(num_frames: int, spans: list[tuple[int, int]] | None) -> np.ndarray:
    """One XD-Violence video's labels from exclusive (start, end) spans clipped to
    ``num_frames``; zeros for a normal video."""
    if not spans:
        return np.zeros(num_frames, dtype=float)
    gt: list[float] = []
    cursor = end = 0
    for start, end in spans:
        gt.extend([0.0] * (start - cursor))
        end = min(end, num_frames)
        gt.extend([1.0] * (end - start))
        cursor = end
    gt.extend([0.0] * (num_frames - end))
    return _trim(np.asarray(gt, dtype=float), num_frames, max_fix=16)


def _trim(gt: np.ndarray, num_frames: int, max_fix: int) -> np.ndarray:
    """Drop a positive remainder under ``max_fix``; any other length mismatch raises."""
    remainder = len(gt) - num_frames
    if remainder == 0:
        return gt
    if 0 < remainder < max_fix:
        return gt[:-remainder]
    raise ValueError(f"gt length {len(gt)} != num_frames {num_frames} (remainder {remainder})")


def parse_xd_annotation_line(line: str) -> tuple[str, list[tuple[int, int]]]:
    """'name s1 e1 s2 e2 ...' -> (name, [(s1, e1), ...])."""
    name, *nums = line.split()
    values = [int(x) for x in nums]
    return name, list(zip(values[::2], values[1::2]))


def build_gt(videos: list[dict], dataset: str, frames_per_clip: int | None = None) -> np.ndarray:
    """The concatenated gt of a test list. ``videos``: {'num_clips': int, and
    'events' (UCF) / 'frame_mask' (ST) / 'spans' (XD)} in test-list order;
    ``frames_per_clip`` defaults to 16 for ST and 32 otherwise."""
    if frames_per_clip is None:
        frames_per_clip = 16 if dataset == "ST" else 32
    build, key = {"UCF": (ucf_video_gt, "events"), "ST": (shanghai_video_gt, "frame_mask"),
                  "XD": (xd_video_gt, "spans")}[dataset]
    return np.concatenate([build(v["num_clips"] * frames_per_clip, v.get(key)) for v in videos])
