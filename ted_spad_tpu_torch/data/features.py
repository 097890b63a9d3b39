"""Precomputed-feature datasets of the MGFN stage and the bucket padding of test
features (counterpart of ted_spad_tpu/data/features.py; reference
anomaly_detection_mgfn/datasets/dataset.py).

Per-video ``.npy`` feature files, ``(T, F)`` or ``(T, ncrops, F)``, are listed one per
line in ``.list`` files. Training splits the list abnormal-first at a fixed index
(UCF 810 / ST 63 / XD 1905, dataset.py:26-48); the video-level label is 0 (normal) or
1 (abnormal) by split membership (dataset.py:136-143). The train loader yields paired
(normal, abnormal) half-batches that the step concatenates (train.py:82-85). Test
videos are padded to a bucket length with a validity mask; with MGFN's mask support
the padded forward equals the native-length one (models/mgfn.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

from ted_spad_tpu_torch.ops.temporal import segment_train_features, test_features

ABNORMAL_SPLIT = {"UCF": 810, "ST": 63, "XD": 1905}  # dataset.py:26-48


def read_list(list_file: str) -> list[str]:
    with open(list_file) as f:
        return [ln.strip() for ln in f if ln.strip()]


def split_train_list(paths: list[str], datasetname: str, is_normal: bool) -> list[str]:
    """Abnormal-first fixed-index split (dataset.py:26-48)."""
    idx = ABNORMAL_SPLIT[datasetname]
    return paths[idx:] if is_normal else paths[:idx]


def load_video_features(path: str) -> np.ndarray:
    """One video's features, (T, F) or (T, ncrops, F), as float32. Paths are taken as
    they are (the reference rewrites ``_mgfn -> _ours``, dataset.py:54)."""
    return np.asarray(np.load(path, allow_pickle=True), dtype=np.float32)


@dataclasses.dataclass
class FeatureDataset:
    """Train-mode dataset: 32-segment pooled features + magnitude, video-level label."""

    list_file: str
    datasetname: str = "UCF"
    is_normal: bool = True
    seg_length: int = 32
    root: str | None = None

    def __post_init__(self):
        self.paths = split_train_list(read_list(self.list_file), self.datasetname, self.is_normal)
        if self.root:
            self.paths = [os.path.join(self.root, p) for p in self.paths]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> tuple[np.ndarray, float]:
        feats = load_video_features(self.paths[i])
        return segment_train_features(feats, self.seg_length), 0.0 if self.is_normal else 1.0


@dataclasses.dataclass
class TestFeatureDataset:
    """Test-mode dataset: full-length features + magnitude per video (dataset.py:68-84)."""

    list_file: str
    datasetname: str = "UCF"
    root: str | None = None

    def __post_init__(self):
        self.paths = read_list(self.list_file)
        if self.root:
            self.paths = [os.path.join(self.root, p) for p in self.paths]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> tuple[np.ndarray, str]:
        feats = test_features(load_video_features(self.paths[i]))  # (T, ncrops, F+1)
        return feats, os.path.basename(self.paths[i])[:-4]

    def peek_shape(self, i: int) -> tuple[int, ...]:
        """The array's shape from the file header (memory-mapped, no data read), so
        the evaluation can bucket videos by length before loading them."""
        return np.load(self.paths[i], mmap_mode="r").shape


def paired_train_batches(
    normal: FeatureDataset,
    abnormal: FeatureDataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = True,
    mesh=None,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (normal_feats, normal_labels, abnormal_feats, abnormal_labels) half-batches,
    as ``zip(nloader, aloader)`` with drop_last (main.py:49-57, train.py:82): an epoch
    is ``min(len(n), len(a)) // batch_size`` steps, in list order unless ``shuffle``.
    The halves always have the same size: the step splits their concatenation at its
    midpoint. With ``mesh`` (parallel.DataParallelMesh) every rank draws the same
    order and loads only its block of each half."""
    rng = np.random.default_rng(seed)
    n_idx = np.arange(len(normal))
    a_idx = np.arange(len(abnormal))
    if shuffle:
        rng.shuffle(n_idx)
        rng.shuffle(a_idx)
    steps = min(len(n_idx), len(a_idx)) // batch_size
    if not drop_last and min(len(n_idx), len(a_idx)) % batch_size:
        steps += 1
    for s in range(steps):
        sl = slice(s * batch_size, (s + 1) * batch_size)
        ns, asl = n_idx[sl], a_idx[sl]
        m = min(len(ns), len(asl))
        if m == 0:
            break
        ns, asl = ns[:m], asl[:m]
        if mesh is not None:
            ns, asl = mesh.take_rows(ns), mesh.take_rows(asl)
        nf, nl = zip(*(normal[int(i)] for i in ns))
        af, al = zip(*(abnormal[int(i)] for i in asl))
        yield np.stack(nf), np.asarray(nl, np.float32), np.stack(af), np.asarray(al, np.float32)


def bucket_length(t: int, multiple: int = 64) -> int:
    """Static-shape bucket for variable-length test videos: next multiple (min 1 bucket)."""
    return max(multiple, ((t + multiple - 1) // multiple) * multiple)


def padded_test_batch(feats: np.ndarray, multiple: int = 64) -> tuple[np.ndarray, np.ndarray, int]:
    """Pad (T, ncrops, F+1) -> ((1, ncrops, Tb, F+1), mask (1, Tb), T)."""
    t, ncrops, c = feats.shape
    tb = bucket_length(t, multiple)
    out = np.zeros((1, ncrops, tb, c), np.float32)
    out[0, :, :t] = feats.transpose(1, 0, 2)
    mask = np.zeros((1, tb), bool)
    mask[0, :t] = True
    return out, mask, t
