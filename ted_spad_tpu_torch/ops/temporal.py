"""Feature transforms of the MGFN stage (counterpart of ted_spad_tpu/ops/temporal.py;
reference datasets/dataset.py:68-100 and utils/utils.py:34-42): 32-segment pooling
for training, the full sequence for testing, each with the magnitude channel."""

from __future__ import annotations

import numpy as np


def process_feat(feat: np.ndarray, length: int = 32) -> np.ndarray:
    """Linear segment mean-pooling of a (T, F) feature sequence to (length, F)
    (utils/utils.py:34-42). Segment bounds from an integer linspace; an empty segment
    copies its boundary row."""
    feat = np.asarray(feat, dtype=np.float32)
    t = feat.shape[0]
    out = np.zeros((length, feat.shape[1]), dtype=np.float32)
    r = np.linspace(0, t, length + 1, dtype=int)
    for i in range(length):
        if r[i] != r[i + 1]:
            out[i] = feat[r[i]:r[i + 1]].mean(axis=0)
        else:
            out[i] = feat[min(r[i], t - 1)]
    return out


def segment_train_features(features: np.ndarray, seg_length: int = 32) -> np.ndarray:
    """Training transform (datasets/dataset.py:86-100): per-crop pooling to
    ``seg_length`` segments plus the magnitude channel.
    (T, F) or (T, ncrops, F) -> (ncrops, seg_length, F+1)."""
    features = np.asarray(features, dtype=np.float32)
    if features.ndim < 3:
        features = features[:, None, :]
    pooled = np.stack([process_feat(f, seg_length) for f in features.transpose(1, 0, 2)])
    return append_magnitude(pooled)


def append_magnitude(features: np.ndarray) -> np.ndarray:
    """Concatenate the per-snippet L2 magnitude as the last feature:
    (..., T, F) -> (..., T, F+1)."""
    mag = np.linalg.norm(features, axis=-1, keepdims=True)
    return np.concatenate([features, mag], axis=-1).astype(np.float32)


def test_features(features: np.ndarray) -> np.ndarray:
    """Full-length sequence plus magnitude: (T, F) or (T, ncrops, F) -> (T, ncrops, F+1)."""
    features = np.asarray(features, dtype=np.float32)
    if features.ndim < 3:
        features = features[:, None, :]
    return append_magnitude(features)
