"""Metrics in numpy (counterpart of ted_spad_tpu/ops/metrics.py): the frame-level
anomaly metrics (reference test.py:32-48) -- ROC AUC, PR AUC (trapezoidal, as the
reference's ``auc(recall, precision)``) and average precision with scikit-learn's
conventions, and the expansion of clip scores to the frame timeline -- the action
stage's top-1 accuracy, and the privacy stage's cMAP and macro P/R/F1."""

from __future__ import annotations

import numpy as np


def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    """``np.trapezoid(y, x)``'s arithmetic, spelled out (numpy 1.x has no trapezoid)."""
    return float((np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum())


def _binary_curve_counts(labels: np.ndarray, scores: np.ndarray):
    """Cumulative TP/FP counts at each distinct score threshold, descending score order."""
    labels = np.asarray(labels).astype(np.float64).ravel()
    scores = np.asarray(scores).astype(np.float64).ravel()
    order = np.argsort(-scores, kind="mergesort")
    scores = scores[order]
    labels = labels[order]
    # Index of the last occurrence of each distinct score.
    threshold_idx = np.r_[np.where(np.diff(scores))[0], labels.size - 1]
    tps = np.cumsum(labels)[threshold_idx]
    fps = 1 + threshold_idx - tps
    return tps, fps, scores[threshold_idx]


def roc_curve(labels: np.ndarray, scores: np.ndarray):
    """(fpr, tpr, thresholds) with sklearn's conventions (a leading (0, 0) point)."""
    tps, fps, thr = _binary_curve_counts(labels, scores)
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thr = np.r_[np.inf, thr]
    p, n = tps[-1], fps[-1]
    tpr = tps / p if p > 0 else np.zeros_like(tps)
    fpr = fps / n if n > 0 else np.zeros_like(fps)
    return fpr, tpr, thr


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(labels, scores)
    return _trapezoid(tpr, fpr)


def precision_recall_curve(labels: np.ndarray, scores: np.ndarray):
    """(precision, recall, thresholds) with sklearn's conventions (from the highest
    threshold down, then a trailing (1, 0) point)."""
    tps, fps, thr = _binary_curve_counts(labels, scores)
    p = tps[-1]
    precision = tps / np.maximum(tps + fps, 1)
    recall = tps / p if p > 0 else np.zeros_like(tps)
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thr[::-1]


def pr_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Trapezoidal area under the PR curve: the reference's ``auc(recall, precision)``
    (test.py:47-48), not average precision."""
    precision, recall, _ = precision_recall_curve(labels, scores)
    return _trapezoid(precision[::-1], recall[::-1])  # recall ascending


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """sklearn ``average_precision_score``: the sum over thresholds of dRecall * precision."""
    tps, fps, _ = _binary_curve_counts(labels, scores)
    p = tps[-1]
    if p == 0:
        return 0.0
    precision = tps / np.maximum(tps + fps, 1)
    recall = tps / p
    return float(np.sum((recall - np.r_[0.0, recall[:-1]]) * precision))


def macro_average_precision(labels: np.ndarray, scores: np.ndarray) -> tuple[float, np.ndarray]:
    """cMAP over the privacy attributes: each class's average precision, then their
    unweighted mean (train_privacy.py:113-119); a class with no positive reads 0.
    ``labels`` / ``scores``: (N, num_classes). Returns (cMAP, per-class AP)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    per_class = np.array([average_precision(labels[:, c], scores[:, c])
                          for c in range(labels.shape[1])])
    return float(per_class.mean()), per_class


def multilabel_prf1(labels: np.ndarray, scores: np.ndarray,
                    threshold: float = 0.5) -> tuple[float, float, float]:
    """Macro precision, recall and F1 at a fixed score threshold (train_privacy.py:104-112)."""
    labels = np.asarray(labels) > 0.5
    preds = np.asarray(scores) > threshold
    eps = 1e-12
    tp = (labels & preds).sum(0).astype(np.float64)
    fp = (~labels & preds).sum(0).astype(np.float64)
    fn = (labels & ~preds).sum(0).astype(np.float64)
    precision = tp / np.maximum(tp + fp, eps)
    recall = tp / np.maximum(tp + fn, eps)
    f1 = 2 * precision * recall / np.maximum(precision + recall, eps)
    return float(precision.mean()), float(recall.mean()), float(f1.mean())


def top1_accuracy(mean_probs: np.ndarray, labels: np.ndarray) -> float:
    """Top-1 of (N, C) class probabilities already averaged over each video's views
    (train_action.py:347-376)."""
    return float((np.argmax(mean_probs, axis=1) == np.asarray(labels)).mean())


def frame_level_scores(
    clip_scores: np.ndarray, num_gt_frames: int, frames_per_clip: int = 32
) -> np.ndarray:
    """Expand per-clip anomaly scores to frame level: each clip covers
    ``frames_per_clip`` original frames; if the expanded length mismatches the
    frame count, redistribute by length ratio exactly as the reference's fallback."""
    pred = np.repeat(np.asarray(clip_scores, dtype=np.float32).ravel(), frames_per_clip)
    ratio = float(num_gt_frames) / float(len(pred))
    if ratio == 1.0:
        return pred
    final = np.zeros(num_gt_frames, dtype=np.float32)
    for i in range(len(pred)):
        b = int(i * ratio + 0.5)
        e = int((i + 1) * ratio + 0.5)
        final[b:e] = pred[i]
    return final
