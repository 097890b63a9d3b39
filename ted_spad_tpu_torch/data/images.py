"""Image sources (counterpart of ted_spad_tpu/data/images.py): the VISPR
privacy-attribute splits of privacy training and the adversarial stage
(aux_code/vispr_dl.py: vispr_dataset :18, vispr_ssl_dataset :133,
vispr_boring_dataset :255) and the image mix of fa pretraining
(fa_pretraining/reconstruction_dl.py:17).

The host decodes JPEGs (PIL) to a canonical square so batches are dense; the
augmentation draw is numpy here (``sample_image_augment_params``, the JAX package's
draw order, so one seed gives the same batches in both) and the pixel work runs on
the images' device (ops/augment.py). Labels are multi-hot privacy-attribute vectors
from ``{split}_labels.pkl``. As in the JAX package, crops are taken on the canonical
host copy, not on the original resolution.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from ted_spad_tpu_torch.ops.augment import AugmentParams

CANONICAL = 256  # host-side canonical square size fed to device-side crops


def load_vispr_labels(pkl_path: str) -> dict[str, np.ndarray]:
    """{image name: multi-hot attribute vector} (vispr_dl.py:21)."""
    with open(pkl_path, "rb") as f:
        return pickle.load(f)


def decode_image_canonical(path: str, size: int = CANONICAL) -> np.ndarray:
    """Decode a JPEG/PNG, gray->RGB (vispr_dl.py:50-52), short-side resize + center crop to
    (size, size, 3) uint8."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = size / min(w, h)
        im = im.resize((max(int(w * scale + 0.5), size), max(int(h * scale + 0.5), size)), Image.BILINEAR)
        w, h = im.size
        x0, y0 = (w - size) // 2, (h - size) // 2
        im = im.crop((x0, y0, x0 + size, y0 + size))
        return np.asarray(im, dtype=np.uint8)


class VisprImageSource:
    """File-backed VISPR split: a folder of jpgs and its labels pickle
    (vispr_dl.py:18-33). ``shuffle`` permutes the sorted paths with ``seed`` before
    ``data_percentage`` keeps their head, as the JAX package does."""

    def __init__(
        self,
        data_dir: str,
        labels_pkl: str,
        shuffle: bool = True,
        data_percentage: float = 1.0,
        seed: int = 0,
        canonical: int = CANONICAL,
        num_workers: int = 8,
    ):
        self.labels = load_vispr_labels(labels_pkl)
        paths = sorted(glob.glob(os.path.join(data_dir, "*.jpg")))
        if shuffle:
            np.random.default_rng(seed).shuffle(paths)
        self.paths = paths[: int(len(paths) * data_percentage)]
        self.canonical = canonical
        self._pool = ThreadPoolExecutor(num_workers)

    def __len__(self) -> int:
        return len(self.paths)

    def label_of(self, path: str) -> np.ndarray:
        return np.asarray(self.labels[os.path.basename(path).replace(".jpg", "")], np.float32)

    def get_batch(self, indices: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
        paths = [self.paths[i] for i in indices]
        imgs = list(self._pool.map(lambda p: decode_image_canonical(p, self.canonical), paths))
        labels = np.stack([self.label_of(p) for p in paths])
        return np.stack(imgs), labels


# One saturated, mutually distinct colour per privacy attribute (style="attrs").
_ATTR_COLORS = np.array(
    [
        [255, 32, 32], [32, 255, 32], [32, 96, 255], [255, 255, 32],
        [255, 32, 255], [32, 255, 255], [255, 144, 32],
    ],
    np.uint8,
)


class SyntheticImageSource:
    """Deterministic procedural images with multi-hot labels: the in-memory stand-in
    that runs fa pretraining, privacy training and the adversarial stage without
    images on disk (the JAX package's source, image for image).

    ``style``:
      - ``"stripes"`` (default): label-correlated stripe frequencies, two of the
        attributes visually encoded;
      - ``"attrs"``: every attribute encoded as a coloured patch (a colour and a
        position per attribute, present iff its label bit is set) over a per-image
        smooth random background. A raw privacy attacker can then reach a high cMAP,
        and an anonymizer that destroys an image's distinctive content erases exactly
        the attribute evidence, so the paper's cMAP reduction is observable on
        synthetic data (``validate_adversarial``). The background is the identity
        signal the NT-Xent attacker matches views with.
    """

    def __init__(self, n: int = 256, num_pa: int = 7, seed: int = 0, canonical: int = CANONICAL,
                 style: str = "stripes"):
        self.n = n
        self.num_pa = num_pa
        self.seed = seed
        self.canonical = canonical
        self.style = style
        rng = np.random.default_rng(seed)
        self._labels = (rng.random((n, num_pa)) < 0.3).astype(np.float32)

    def __len__(self) -> int:
        return self.n

    def _image(self, i: int) -> np.ndarray:
        if self.style == "attrs":
            return self._image_attrs(i)
        s = self.canonical
        yy, xx = np.mgrid[0:s, 0:s]
        k = (self.seed * 131 + i * 17) % 251
        # Label-correlated structure so privacy classifiers can actually learn.
        r = (xx + k * 3) % 256
        g = (yy * (1 + int(self._labels[i, 0])) + k) % 256
        b = ((xx + yy) // 2 + int(self._labels[i, 1 % self.num_pa]) * 100) % 256
        return np.stack([r, g, b], axis=-1).astype(np.uint8)

    def _image_attrs(self, i: int) -> np.ndarray:
        s = self.canonical
        rng = np.random.default_rng((self.seed + 1) * 100003 + i)
        # Smooth random background: a per-image identity texture for the SSL pair.
        cell = max(s // 4, 1)
        reps = -(-s // cell)
        bg = rng.integers(32, 224, (reps, reps, 3))
        img = np.kron(bg, np.ones((cell, cell, 1))).astype(np.uint8)[:s, :s]
        ps = max(s // 4, 4)  # the patch survives the 0.6-1.0 random crop and the resize
        for k in range(self.num_pa):
            if self._labels[i, k] > 0:
                gy, gx = divmod(k % 9, 3)
                y0 = int(s * (0.12 + 0.28 * gy))
                x0 = int(s * (0.12 + 0.28 * gx))
                c = _ATTR_COLORS[k % len(_ATTR_COLORS)]
                img[y0 : y0 + ps, x0 : x0 + ps] = c
                q = ps // 3  # a contrasting core: robust to mild colour jitter
                img[y0 + q : y0 + 2 * q, x0 + q : x0 + 2 * q] = 255 - c
        return img

    def get_batch(self, indices: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
        return np.stack([self._image(int(i) % self.n) for i in indices]), self._labels[
            np.asarray(indices) % self.n
        ]


def sample_image_augment_params(
    rng: np.random.Generator,
    batch: int,
    src: int = CANONICAL,
    out_h: int = 224,
    out_w: int = 224,
    erase_size: int = 19,
    shared_crop_origin: np.ndarray | None = None,
) -> AugmentParams:
    """Image-stage augmentation draw (vispr_dl.py:72-123). Differences from the video draw:
    single erase box gated at p=0.25 on the *hflip* random slot (vispr_dl.py:115-121 uses
    random_array[6] twice — faithful), erase sizes ~U[erase/2, erase). ``shared_crop_origin``
    (y0, x0 arrays) reproduces the SSL pair trick: both views share the crop origin while
    sizes differ (vispr_dl.py:197-199 vs :214)."""
    cf = rng.uniform(0.6, 1.0, size=batch)
    crop = (src * cf).astype(np.int32)
    if shared_crop_origin is None:
        x0 = (rng.random(batch) * (src - crop + 1)).astype(np.int32)
        y0 = (rng.random(batch) * (src - crop + 1)).astype(np.int32)
    else:
        y0, x0 = shared_crop_origin
        y0 = np.minimum(y0, src - crop)
        x0 = np.minimum(x0, src - crop)
    r = rng.random((batch, 8))
    return AugmentParams(
        y0=y0,
        x0=x0,
        crop_h=crop,
        crop_w=crop.copy(),
        do_contrast=r[:, 0] < 0.125,
        contrast=rng.uniform(0.9, 1.1, batch),
        do_hue=r[:, 1] < 0.15,
        hue=rng.uniform(-0.05, 0.05, batch),
        do_saturation=r[:, 2] < 0.15,
        saturation=rng.uniform(0.9, 1.1, batch),
        do_brightness=r[:, 3] < 0.15,
        brightness=rng.uniform(0.9, 1.1, batch),
        do_grayscale=r[:, 4] > 0.9,
        do_gamma=(r[:, 4] > 0.9) & (r[:, 5] > 0.25),
        gamma=rng.uniform(0.85, 1.15, batch),
        do_hflip=r[:, 6] > 0.5,
        do_erase=np.stack([r[:, 6] < 0.25, np.zeros(batch, bool)], axis=1),
        erase_y=rng.integers(0, out_h, size=(batch, 2)).astype(np.int32),
        erase_x=rng.integers(0, out_w, size=(batch, 2)).astype(np.int32),
        erase_h=rng.integers(erase_size // 2, erase_size, size=(batch, 2)).astype(np.int32),
        erase_w=rng.integers(erase_size // 2, erase_size, size=(batch, 2)).astype(np.int32),
    )


@dataclasses.dataclass
class ImageBatch:
    """Host-side batch: canonical uint8 images, labels, and the augmentation draws
    (view 1 when training, view 2 for an SSL pair)."""

    images: np.ndarray  # (B, S, S, 3) uint8
    labels: np.ndarray  # (B, num_pa) float32
    params: AugmentParams | None = None
    params2: AugmentParams | None = None


def vispr_batches(
    source,
    batch_size: int,
    *,
    train: bool = True,
    ssl: bool = False,
    out_h: int = 224,
    out_w: int = 224,
    seed: int = 0,
    drop_last: bool = True,
    mesh=None,
    parts: int = 1,
) -> Iterator[ImageBatch]:
    """One epoch of batches, shuffled with ``seed`` when ``train``. ``ssl`` adds a
    second draw whose crop shares the first one's origin (the NT-Xent positive pair,
    vispr_ssl_dataset). Eval batches carry no draw: the stage centre-crops them.
    With ``mesh`` (parallel.DataParallelMesh, train batches) every rank draws the
    same order and augmentation and loads only its rows (``mesh.row_index(B,
    parts)``); the batch size must shard over it."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(source))
    if train:
        rng.shuffle(order)
    n_steps = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
    for s in range(n_steps):
        idx = order[s * batch_size: (s + 1) * batch_size]
        if len(idx) == 0:
            return
        shard = mesh is not None and train
        images, labels = source.get_batch(idx[mesh.row_index(len(idx), parts)] if shard else idx)
        if not train:
            yield ImageBatch(images, labels)
            continue
        src = images.shape[1]
        p1 = sample_image_augment_params(rng, len(idx), src, out_h, out_w)
        p2 = None
        if ssl:
            p2 = sample_image_augment_params(rng, len(idx), src, out_h, out_w,
                                             shared_crop_origin=(p1.y0.copy(), p1.x0.copy()))
        if shard:
            p1, p2 = mesh.take_rows(p1, parts=parts), mesh.take_rows(p2, parts=parts)
        yield ImageBatch(images, labels, p1, p2)


def boring_video_batch(images: np.ndarray, num_frames: int) -> np.ndarray:
    """vispr_boring_dataset (vispr_dl.py:255-308): each image repeated ``num_frames``
    times as a still video, (B, S, S, 3) -> (B, T, S, S, 3)."""
    return np.repeat(images[:, None], num_frames, axis=1)


class ReconstructionSource:
    """fa-pretraining mix: UCF101 frame jpgs + VISPR jpgs in one pool
    (reconstruction_dl.py:20-41). File-backed variant takes explicit path lists; the
    synthetic variant mixes procedural 'frames' and 'photos'."""

    def __init__(self, image_paths: list[str] | None = None, synthetic_n: int = 0, seed: int = 0, canonical: int = CANONICAL):
        self.paths = image_paths or []
        self.canonical = canonical
        self._synth = SyntheticImageSource(synthetic_n, seed=seed, canonical=canonical) if synthetic_n else None
        self._pool = ThreadPoolExecutor(8) if self.paths else None

    def __len__(self) -> int:
        return len(self.paths) if self.paths else len(self._synth)

    def get_batch(self, indices: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
        if self.paths:
            imgs = list(
                self._pool.map(lambda i: decode_image_canonical(self.paths[int(i)], self.canonical), indices)
            )
            images = np.stack(imgs)
            return images, np.zeros((len(imgs), 0), np.float32)
        return self._synth.get_batch(indices)
