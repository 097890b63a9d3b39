"""Video clip datasets: UCF101-style single and contrastive clip sampling (counterpart
of ted_spad_tpu/data/videos.py; reference aux_code/ucf101_dl.py -- single_train_dataloader
:23, single_val_dataloader :199, contrastive_train_dataloader :324, the collate
None-filter :900-936, the palindrome completion of short clips :550-567).

Host threads decode fixed-resolution uint8 clips (data/video_reader.py); the
augmentation draw is sampled here (ops/augment.py), the pixel work runs on the
clips' device in the train step. Everything here is numpy, in the JAX package's
draw order, so the same seeds give the same indices, items, batches and draws.

Batch layout: ``(B, V, T, H, W, C)`` uint8, V views (1 single; 2 'con'; 3 'trip':
anchor, positive = the same frames, negative = a shifted clip).
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from ted_spad_tpu_torch.data.video_reader import open_video
from ted_spad_tpu_torch.ops.augment import AugmentParams, expand_framewise, sample_augment_params


# ---------------------------------------------------------------------------
# Frame-index samplers (pure functions; unit-testable against reference rules)
# ---------------------------------------------------------------------------


def _clip_indices(start: int, num_frames: int, skip: float) -> np.ndarray:
    idx = start + np.asarray([int(int(skip) * f) for f in range(num_frames)])
    return idx


def palindrome_complete(idx: np.ndarray, frame_count: int) -> np.ndarray | None:
    """The reference's short-clip palindrome rule, applied in index space
    (ucf101_dl.py:550-567 contrastive train; :823-833 contrastive val, non-threecrop):
    a clip whose trailing indices run past the video keeps its k valid frames and
    completes with REVERSED frames ``valid[::-1][1 : n-k+1]`` (motion bounces back
    instead of freezing on the last frame). When k <= n/2 the reference's length
    assert fails and the clip becomes None (collate filter) — same here."""
    n = len(idx)
    valid = idx[idx < frame_count]
    k = len(valid)
    if k == n:
        return idx
    if k <= n / 2:
        return None
    return np.concatenate([valid, valid[::-1][1 : n - k + 1]])


def sample_train_clip(
    rng: np.random.Generator, frame_count: int, num_frames: int, fix_skip: int,
    palindrome: bool = False,
) -> np.ndarray:
    """Random-start strided clip with the halve-skip fallback for short videos
    (ucf101_dl.py:71-87). ``palindrome=True`` (the contrastive loaders) completes
    short clips with reversed frames per :func:`palindrome_complete`; otherwise the
    last index clamps to frame_count-1 (the single_* loaders have no palindrome
    block — documented divergence: clamp vs decord's short return)."""
    skip = float(fix_skip)
    left_over = frame_count - skip * num_frames
    if left_over <= 0:
        skip /= 2
        left_over = frame_count - skip * num_frames
    start = int(rng.integers(0, max(int(left_over), 1)))
    idx = _clip_indices(start, num_frames, skip)
    if palindrome:
        out = palindrome_complete(idx, frame_count)
        if out is None:
            raise ValueError(f"clip too short ({frame_count} frames) — dropped")
        return out
    idx[idx >= frame_count] = frame_count - 1
    return idx


def sample_triplet_clips(
    rng: np.random.Generator,
    frame_count: int,
    num_frames: int,
    fix_skip: int,
    temporal_distance: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(anchor, positive, negative) frame lists for 'trip' (ucf101_dl.py:388-456).

    positive == anchor frames (temporal_align forced for trip, :441-443); negative starts
    either at a fixed ``temporal_distance`` after the anchor's last frame (:400-412) or at
    an independent random position (:447-449)."""
    skip = float(fix_skip)
    left_over = frame_count - skip * num_frames
    if temporal_distance:
        left_over2 = left_over - skip * num_frames - temporal_distance
        if left_over2 <= 0:
            skip /= 2
            left_over = frame_count - skip * num_frames
            left_over2 = left_over - skip * num_frames - temporal_distance
        start = int(rng.integers(0, max(int(left_over2), 1)))
        start_neg = start + int(skip) * (num_frames - 1) + temporal_distance
    else:
        if left_over <= 0:
            skip /= 2
            left_over = frame_count - skip * num_frames
        start = int(rng.integers(0, max(int(left_over), 1)))
        start_neg = int(rng.integers(0, max(int(left_over), 1)))
    anchor = palindrome_complete(_clip_indices(start, num_frames, skip), frame_count)
    neg = palindrome_complete(_clip_indices(start_neg, num_frames, skip), frame_count)
    if anchor is None or neg is None:
        # The reference's length assert fails -> clip dropped (collate None-filter).
        raise ValueError(f"triplet clip too short ({frame_count} frames) — dropped")
    return anchor, anchor.copy(), neg


def val_clip_indices(
    frame_count: int, num_frames: int, fix_skip: int, mode: int, num_modes: int,
    palindrome: bool = False,
) -> np.ndarray:
    """Deterministic mode-indexed start: linspace(0, F-10, num_modes)[mode]
    (ucf101_dl.py:260-279). ``palindrome``: contrastive-val short-clip completion
    (:823-833; the reference skips it under threecrop)."""
    skip = float(fix_skip)
    if skip * num_frames > frame_count:
        skip /= 2
    f = frame_count - skip * num_frames
    start = int(np.linspace(0, f - 10, num_modes)[mode])
    if start < 0:
        start = mode
    idx = _clip_indices(start, num_frames, skip)
    if palindrome:
        out = palindrome_complete(idx, frame_count)
        if out is None:
            raise ValueError(f"val clip too short ({frame_count} frames) — dropped")
        return out
    idx[idx >= frame_count] = frame_count - 1
    return idx


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VideoItem:
    uri: str
    label: int


def load_ucf101_list(
    list_file: str, videos_dir: str, class_mapping_json: str | None = None
) -> list[VideoItem]:
    """Parse a UCF101 trainlist/testlist split file + class mapping (ucf101_dl.py:31-38,
    244-249): lines '<Class>/<vid>.avi[ label]'; labels come from the mapping json
    (action_classes.json format, {"classes": {name: id}}). Without a mapping file, ids
    come from the sorted class subdirectories of ``videos_dir`` (the same 1-based ids
    for every list over that tree — a train list and a partial val list must agree),
    falling back to the names in the list only when the directory can't provide them."""
    lines = [ln for ln in open(list_file).read().splitlines() if ln.strip()]
    rels = [ln.split(" ")[0].replace("/", os.sep) for ln in lines]
    if class_mapping_json and os.path.exists(class_mapping_json):
        classes = json.load(open(class_mapping_json))["classes"]
    else:
        listed = sorted({r.split(os.sep)[0] for r in rels})
        names = (
            sorted(
                d for d in os.listdir(videos_dir)
                if os.path.isdir(os.path.join(videos_dir, d))
            )
            if os.path.isdir(videos_dir)
            else []
        )
        if not set(listed) <= set(names):
            names = listed
        classes = {name: i + 1 for i, name in enumerate(names)}
    return [
        VideoItem(os.path.join(videos_dir, rel), int(classes[rel.split(os.sep)[0]]))
        for rel in rels
    ]


def synthetic_video_items(
    n: int, num_classes: int, num_frames: int = 120, h: int = 112, w: int = 144, seed: int = 0
) -> list[VideoItem]:
    """Synthetic class-correlated videos via synthetic:// URIs (video_reader.py): seed
    encodes the class so models can fit them — the in-memory dataset for e2e tests."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        label = int(rng.integers(0, num_classes))
        uri = f"synthetic://n={num_frames},h={h},w={w},seed={label * 1000 + i}"
        items.append(VideoItem(uri, label))
    return items


# ---------------------------------------------------------------------------
# Batch iterators (host threads decode; the clips' device augments)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClipBatch:
    clips: np.ndarray  # (B, V, T, H, W, C) uint8
    labels: np.ndarray  # (B,) int32
    params: AugmentParams | None  # per-(B*V) flattened draw; None for val
    indices: np.ndarray | None = None  # video indices within the dataset (val bookkeeping)
    sharded: bool = False  # the rows are this rank's of a global batch (data parallel)


class ClipDataset:
    """Train-mode clip dataset over a list of VideoItems."""

    def __init__(
        self,
        items: Sequence[VideoItem],
        params,
        *,
        views: int = 1,  # 1 = single_train; 3 = contrastive 'trip'
        decode_w: int = 0,
        decode_h: int = 0,
        num_workers: int = 8,
        data_percentage: float = 1.0,
        shuffle_init: bool = True,
        seed: int = 0,
    ):
        items = list(items)
        if shuffle_init:
            np.random.default_rng(seed).shuffle(items)
        self.items = items[: int(len(items) * data_percentage)]
        self.p = params
        self.views = views
        self.decode_w = decode_w
        self.decode_h = decode_h
        self._pool = ThreadPoolExecutor(num_workers)

    def __len__(self) -> int:
        return len(self.items)

    def close(self) -> None:
        """Stop the decode threads."""
        self._pool.shutdown(wait=True)

    def _load_one(self, item: VideoItem, seed: int) -> np.ndarray | None:
        """Decode one item's view stack (V, T, H, W, C) uint8, or None on failure — the
        reference's per-clip try/except->None fixture (ucf101_dl.py:143-146)."""
        rng = np.random.default_rng(seed)
        try:
            vr = open_video(item.uri, self.decode_w, self.decode_h, threads=1)
            n = len(vr)
            if self.views == 1:
                idx_sets = [sample_train_clip(rng, n, self.p.num_frames, self.p.fix_skip)]
            elif self.views == 2:
                # 'con' pair: independent random second clip (temporal_align=False default,
                # ucf101_dl.py:424-425); aligned when the params force it. Contrastive
                # loaders apply the short-clip palindrome rule (:550-560).
                a = sample_train_clip(rng, n, self.p.num_frames, self.p.fix_skip, palindrome=True)
                if getattr(self.p, "temporal_align", False):
                    idx_sets = [a, a.copy()]
                else:
                    idx_sets = [
                        a,
                        sample_train_clip(rng, n, self.p.num_frames, self.p.fix_skip, palindrome=True),
                    ]
            else:
                idx_sets = list(
                    sample_triplet_clips(
                        rng, n, self.p.num_frames, self.p.fix_skip, getattr(self.p, "temporal_distance", None)
                    )
                )
            anchor = vr.get_batch(idx_sets[0])
            views = [anchor]
            for s in idx_sets[1:]:
                views.append(anchor if np.array_equal(s, idx_sets[0]) else vr.get_batch(s))
            vr.close()
            return np.stack(views)
        except Exception:  # noqa: BLE001 — corrupt-video tolerance
            return None

    def batches(self, batch_size: int, *, seed: int = 0, drop_last: bool = True,
                mesh=None, parts: int = 1) -> Iterator[ClipBatch]:
        """One epoch of batches in the seed's order. With ``mesh``
        (parallel.DataParallelMesh) every rank draws the same order, seeds and
        augmentation, and decodes only its rows (``mesh.row_index(B, parts)``); the
        batch is ``sharded``. A batch the mesh does not divide is decoded whole on
        every rank, and so is one where any rank's decode failed (the ranks swap their
        clips, and the survivors run replicated, as one process runs them)."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.items))
        steps = len(order) // batch_size if drop_last else (len(order) + batch_size - 1) // batch_size
        for s in range(steps):
            idx = order[s * batch_size : (s + 1) * batch_size]
            if len(idx) == 0:
                return
            seeds = rng.integers(0, 2**31, size=len(idx))
            local = None
            if mesh is not None and mesh.divides(len(idx), parts):
                local = mesh.row_index(len(idx), parts)
                loaded = list(self._pool.map(self._load_one, [self.items[i] for i in idx[local]],
                                             seeds[local]))
                if any(mesh.exchange(any(c is None for c in loaded))):  # a decode failed
                    full: list = [None] * len(idx)
                    for r, piece in enumerate(mesh.exchange(loaded)):
                        for k, c in zip(mesh.row_index(len(idx), parts, rank=r), piece):
                            full[k] = c
                    loaded, local = full, None
            else:
                loaded = list(self._pool.map(self._load_one, [self.items[i] for i in idx], seeds))
            keep = list(range(len(idx))) if local is not None else [
                k for k, c in enumerate(loaded) if c is not None]
            if len(keep) < 2:  # collate min-2 filter (ucf101_dl.py:911-912)
                continue
            clips = np.stack(loaded if local is not None else [loaded[k] for k in keep])
            labels = np.asarray([self.items[idx[k]].label for k in keep], np.int32)
            b, v = len(keep), clips.shape[1]  # (B, V, T, H, W, C), B global
            aug = sample_augment_params(
                rng,
                b * v,
                clips.shape[-3],
                clips.shape[-2],
                self.p.reso_h,
                self.p.reso_w,
                min_crop=getattr(self.p, "min_crop_factor_training", 0.6),
                no_ar_distortion=getattr(self.p, "no_ar_distortion", False),
                aspect_ratio_aug=getattr(self.p, "aspect_ratio_aug", False),
                weak=getattr(self.p, "weak_aug", False),
            )
            # Views of one video share the crop ORIGIN but keep their own crop sizes
            # (ucf101_dl.py:516-548: x0/y0 reused, cropping_factor1[i] per view) — with
            # shared sizes too, weak-aug triplet positives would be pixel-identical to
            # their anchors. Boxes may hang past the edge at the shared origin; the
            # affine resample zero-pads there, like the reference's resized_crop.
            for field in ("y0", "x0"):
                arr = getattr(aug, field).reshape(b, v)
                arr[:, 1:] = arr[:, :1]
            if getattr(self.p, "frame_wise_aug", False) and not getattr(self.p, "weak_aug", False):
                aug = expand_framewise(aug, clips.shape[2], rng)
            if local is not None:
                yield ClipBatch(clips, mesh.take_rows(labels, parts=parts),
                                mesh.take_rows(aug, b, parts), sharded=True)
            else:
                yield ClipBatch(clips, labels, aug)


class ValClipDataset:
    """Validation clips: deterministic (mode, hflip, cropping_factor) views
    (ucf101_dl.py:199-320). The stage sweeps modes x crop factors and averages softmax
    per video (train_action.py:330-381)."""

    def __init__(
        self,
        items: Sequence[VideoItem],
        params,
        *,
        mode: int = 0,
        decode_w: int = 0,
        decode_h: int = 0,
        num_workers: int = 8,
        data_percentage: float = 1.0,
    ):
        self.items = list(items)[: int(len(items) * data_percentage)]
        self.p = params
        self.mode = mode
        self.decode_w = decode_w
        self.decode_h = decode_h
        self._pool = ThreadPoolExecutor(num_workers)

    def __len__(self) -> int:
        return len(self.items)

    def close(self) -> None:
        """Stop the decode threads."""
        self._pool.shutdown(wait=True)

    def _load_one(self, item: VideoItem) -> np.ndarray | None:
        try:
            vr = open_video(item.uri, self.decode_w, self.decode_h, threads=1)
            # Loader selection follows the reference (train_action.py:335-339,
            # train_anonymizer.py:464-467): the CONTRASTIVE val loader — the one with
            # the palindrome rule (ucf101_dl.py:823-833, skipped under threecrop) —
            # is used iff loss=='con' or temporal_loss=='trip'; plain CE validation
            # uses single_val_dataloader, which clamps.
            contrastive = (
                getattr(self.p, "loss", None) == "con"
                or getattr(self.p, "temporal_loss", None) == "trip"
            )
            idx = val_clip_indices(
                len(vr), self.p.num_frames, self.p.fix_skip, self.mode, self.p.num_modes,
                palindrome=contrastive and not getattr(self.p, "three_crop", False),
            )
            clip = vr.get_batch(idx)
            vr.close()
            return clip
        except Exception:  # noqa: BLE001
            return None

    def batches(self, batch_size: int) -> Iterator[ClipBatch]:
        for s in range((len(self.items) + batch_size - 1) // batch_size):
            ids = np.arange(s * batch_size, min((s + 1) * batch_size, len(self.items)))
            loaded = list(self._pool.map(self._load_one, [self.items[i] for i in ids]))
            keep = [k for k, c in enumerate(loaded) if c is not None]
            if not keep:
                continue
            clips = np.stack([loaded[k] for k in keep])[:, None]  # (B, 1, T, H, W, C)
            labels = np.asarray([self.items[ids[k]].label for k in keep], np.int32)
            yield ClipBatch(clips, labels, None, indices=ids[keep])
