"""Temporal layout and feature transforms (counterpart of ted_spad_tpu/ops/temporal.py).

- The reference's frame-layout quirks on torch tensors: ``scrambled_frame_view`` and
  its inverse (the anonymizer training's fa input, train_anonymizer.py:86-92) and
  ``extraction_return_scramble`` (the extraction's fa return,
  dali_extraction.py:168-173), which ``quirk_compat`` extraction applies.
- The MGFN stage's feature transforms (datasets/dataset.py:68-100,
  utils/utils.py:34-42): 32-segment pooling for training, the full sequence for
  testing, each with the magnitude channel.
"""

from __future__ import annotations

import numpy as np
import torch


def scrambled_frame_view(video: torch.Tensor) -> torch.Tensor:
    """The reference's fa-input layout: it permutes (B, T, H, W, C) video to
    (B, C, T, H, W) and reshapes that to (B*T, C, H, W), so each pseudo-frame stacks
    3 consecutive slices of the (C, T) axis in linear order (across a channel
    boundary when T % 3 != 0). Channels-last (B, T, H, W, 3) -> (B*T, H, W, 3)."""
    b, t, h, w, c = video.shape
    if c != 3:
        raise ValueError("the quirk view needs RGB input")
    bundles = video.permute(0, 4, 1, 2, 3).reshape(b * t, 3, h, w)
    return bundles.permute(0, 2, 3, 1)


def unscrambled_frame_view(frames: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """The inverse of ``scrambled_frame_view``: (B*T, H, W, 3) -> (B, T, H, W, 3)."""
    n, h, w, _ = frames.shape
    if n != b * t:
        raise ValueError(f"{n} pseudo-frames are not {b} x {t}")
    return frames.permute(0, 3, 1, 2).reshape(b, 3, t, h, w).permute(0, 2, 3, 4, 1)


def extraction_return_scramble(frames: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """The extraction's quirk: fa runs on clean (B*T, C, H, W) frames, but its output
    is reshaped to (B, C, T, H, W), reading the (B, T, C) memory as (B, C, T), so
    ft's channel c at time t is frame (c*T + t) // 3, channel (c*T + t) % 3.
    Channels-last fa output (B*T, H, W, 3) -> the (B, T, H, W, 3) clip ft sees."""
    n, h, w, c = frames.shape
    if n != b * t or c != 3:
        raise ValueError(f"expected ({b * t}, H, W, 3) frames, got {tuple(frames.shape)}")
    return frames.permute(0, 3, 1, 2).reshape(b, c, t, h, w).permute(0, 2, 3, 4, 1)


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
