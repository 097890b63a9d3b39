"""Parity of the port's training data with ted_spad_tpu's: clip sampling, the video
items and list files, the train and validation clip datasets (batches, labels and
augmentation draws), frame reads in request order, and the fa-pretraining image
sources and draws. Everything is numpy: the same seeds must give the same results,
exactly. Last, both training CLIs on their synthetic data."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from ted_spad_tpu.config.params import ActionParams as JaxActionParams
from ted_spad_tpu.data import images as jax_images
from ted_spad_tpu.data import videos as jax_videos
from ted_spad_tpu.data.video_reader import VideoReader as JaxVideoReader
from ted_spad_tpu.data.video_reader import native_available, write_y4m
from ted_spad_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from ted_spad_tpu_torch.config.params import ActionParams
from ted_spad_tpu_torch.data import images, videos
from ted_spad_tpu_torch.data.video_reader import SyntheticVideoReader, VideoReader

torch.set_num_threads(1)
SMALL = dict(num_frames=8, fix_skip=2, reso_h=24, reso_w=32, num_modes=3)


def same_draw(ours, ref) -> None:
    assert (ours is None) == (ref is None)
    if ref is not None:
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(getattr(ours, f.name), getattr(ref, f.name), err_msg=f.name)


# ---------------------------------------------------------------------------
# Clip sampling
# ---------------------------------------------------------------------------


def _sample(mod, fn: str, seed: int, *args, **kw):
    try:
        return getattr(mod, fn)(np.random.default_rng(seed), *args, **kw)
    except ValueError as e:  # a clip too short for the palindrome rule
        return str(e)


@pytest.mark.parametrize("frame_count", [5, 9, 12, 17, 31, 40, 100])
def test_clip_samplers_match_jax(frame_count):
    """sample_train_clip (clamped and palindromic), sample_triplet_clips (random and
    fixed temporal distance), val_clip_indices and palindrome_complete, over seeds and
    modes, short videos included (the same refusals): equal index lists."""
    for seed in range(4):
        for args, kw in (((8, 2), {}), ((8, 2), {"palindrome": True})):
            a = _sample(videos, "sample_train_clip", seed, frame_count, *args, **kw)
            b = _sample(jax_videos, "sample_train_clip", seed, frame_count, *args, **kw)
            assert type(a) is type(b) and np.array_equal(a, b)
        for dist in (None, 3):
            a = _sample(videos, "sample_triplet_clips", seed, frame_count, 8, 2, dist)
            b = _sample(jax_videos, "sample_triplet_clips", seed, frame_count, 8, 2, dist)
            assert type(a) is type(b)
            assert a == b if isinstance(a, str) else all(np.array_equal(x, y) for x, y in zip(a, b))
    for mode in range(5):
        for pal in (False, True):
            try:
                a = videos.val_clip_indices(frame_count, 8, 2, mode, 5, palindrome=pal)
            except ValueError as e:
                a = str(e)
            try:
                b = jax_videos.val_clip_indices(frame_count, 8, 2, mode, 5, palindrome=pal)
            except ValueError as e:
                b = str(e)
            assert type(a) is type(b) and np.array_equal(a, b)
    idx = np.arange(frame_count - 6, frame_count + 2)
    a, b = videos.palindrome_complete(idx, frame_count), jax_videos.palindrome_complete(idx, frame_count)
    assert (a is None and b is None) or np.array_equal(a, b)


def test_video_items_and_lists_match_jax(tmp_path):
    """synthetic_video_items, and load_ucf101_list with and without a class mapping
    (ids from the class directories)."""
    for n, k, seed in ((7, 4, 0), (20, 101, 3)):
        ours, ref = videos.synthetic_video_items(n, k, seed=seed), jax_videos.synthetic_video_items(n, k, seed=seed)
        assert [dataclasses.astuple(i) for i in ours] == [dataclasses.astuple(i) for i in ref]
    root = tmp_path / "Videos"
    for cls in ("Archery", "Biking", "Diving"):
        (root / cls).mkdir(parents=True)
    lst = tmp_path / "list.txt"
    lst.write_text("Biking/v_Biking_g01_c01.avi 2\nDiving/v_Diving_g02_c01.avi\n\n")
    mapping = tmp_path / "map.json"
    mapping.write_text(json.dumps({"classes": {"Archery": 5, "Biking": 7, "Diving": 9}}))
    for m in (str(mapping), None):
        ours = videos.load_ucf101_list(str(lst), str(root), m)
        ref = jax_videos.load_ucf101_list(str(lst), str(root), m)
        assert [dataclasses.astuple(i) for i in ours] == [dataclasses.astuple(i) for i in ref]


# ---------------------------------------------------------------------------
# Clip datasets
# ---------------------------------------------------------------------------


def _items(mod):
    items = mod.synthetic_video_items(9, 3, num_frames=30, h=20, w=28, seed=1)
    items[4] = mod.VideoItem("synthetic://n=5,h=20,w=28,seed=7", 1)  # too short: None for 'trip'
    items.append(mod.VideoItem("/nonexistent/video.avi", 0))  # fails to open: None
    return items


@pytest.mark.parametrize("views,extra", [(1, {}), (2, {}), (2, {"temporal_align": True}),
                                         (3, {"temporal_distance": 2}), (3, {"weak_aug": True}),
                                         (1, {"frame_wise_aug": True}),
                                         (3, {"aspect_ratio_aug": True})])
def test_clip_dataset_batches_match_jax(views, extra):
    """ClipDataset.batches: the same clips (B, V, T, H, W, 3), labels and augmentation
    draws (shared crop origin per video, frame-wise expansion), with failed items
    dropped by the min-2 collate filter."""
    p, jp = ActionParams(**SMALL, **extra), JaxActionParams(**SMALL, **extra)
    ours = videos.ClipDataset(_items(videos), p, views=views, num_workers=2, seed=4)
    ref = jax_videos.ClipDataset(_items(jax_videos), jp, views=views, num_workers=2, seed=4)
    assert [i.uri for i in ours.items] == [i.uri for i in ref.items]
    got, want = list(ours.batches(3, seed=5)), list(ref.batches(3, seed=5))
    assert len(got) == len(want) >= 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.clips, b.clips)
        np.testing.assert_array_equal(a.labels, b.labels)
        same_draw(a.params, b.params)
    assert got[0].clips.shape[1:3] == (views, 8)


@pytest.mark.parametrize("extra", [{}, {"temporal_loss": "trip"}, {"loss": "con", "three_crop": True}])
def test_val_clip_dataset_batches_match_jax(extra):
    p, jp = ActionParams(**SMALL, **extra), JaxActionParams(**SMALL, **extra)
    for mode in range(3):
        ours = list(videos.ValClipDataset(_items(videos), p, mode=mode, num_workers=2).batches(4))
        ref = list(jax_videos.ValClipDataset(_items(jax_videos), jp, mode=mode, num_workers=2).batches(4))
        assert len(ours) == len(ref) == 3
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.clips, b.clips)
            np.testing.assert_array_equal(a.labels, b.labels)
            np.testing.assert_array_equal(a.indices, b.indices)


def test_synthetic_reader_get_batch_in_request_order():
    r = SyntheticVideoReader(num_frames=10, height=6, width=8, seed=3002)
    frames = r.get_batch([4, 2, 9, 12, 2])
    assert frames.shape == (5, 6, 8, 3)
    np.testing.assert_array_equal(frames[1], frames[4])
    np.testing.assert_array_equal(frames[3], r.get_batch([9])[0])  # past the end: the last frame
    np.testing.assert_array_equal(r.read_strided(1, 3, 3), r.get_batch([1, 4, 7]))


@pytest.mark.skipif(not native_available(), reason="native videodec unavailable")
def test_native_get_batch_matches_jax(tmp_path):
    """VideoReader.get_batch through vd_read_indices on a Y4M file: non-monotonic and
    repeated indices (the palindrome tail) come back in request order, equal to the
    JAX binding's, and to the strided read of the same frames."""
    rng = np.random.default_rng(0)
    path = write_y4m(str(tmp_path / "v.y4m"), rng.integers(0, 256, (12, 16, 24, 3), dtype=np.uint8))
    idx = [3, 5, 7, 9, 11, 9, 7, 5]
    with VideoReader(path) as ours:
        got = ours.get_batch(idx)
        strided = ours.read_strided(3, 5, 2)
    ref = JaxVideoReader(path)
    np.testing.assert_array_equal(got, ref.get_batch(idx))
    ref.close()
    np.testing.assert_array_equal(got[:5], strided)
    np.testing.assert_array_equal(got[5], got[3])


# ---------------------------------------------------------------------------
# Image sources
# ---------------------------------------------------------------------------


def test_image_sources_and_draws_match_jax(tmp_path):
    """SyntheticImageSource, ReconstructionSource (synthetic and over
    image files of several sizes and modes, decoded to the canonical square) and
    sample_image_augment_params (with and without the shared crop origin)."""
    from PIL import Image

    a = images.SyntheticImageSource(12, seed=2, canonical=48).get_batch([0, 5, 17])
    b = jax_images.SyntheticImageSource(12, seed=2, canonical=48).get_batch([0, 5, 17])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    a = images.ReconstructionSource(synthetic_n=6, seed=1, canonical=40)
    b = jax_images.ReconstructionSource(synthetic_n=6, seed=1, canonical=40)
    assert len(a) == len(b) == 6
    np.testing.assert_array_equal(a.get_batch([1, 3])[0], b.get_batch([1, 3])[0])

    rng = np.random.default_rng(3)
    paths = []
    for i, (size, mode) in enumerate((((50, 30), "RGB"), ((31, 64), "L"), ((40, 40), "RGB"))):
        path = str(tmp_path / f"im{i}.{'png' if mode == 'L' else 'jpg'}")
        shape = size[::-1] + ((3,) if mode == "RGB" else ())
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(path)
        paths.append(path)
    a = images.ReconstructionSource(image_paths=paths, canonical=32).get_batch([2, 0, 1])
    b = jax_images.ReconstructionSource(image_paths=paths, canonical=32).get_batch([2, 0, 1])
    assert a[0].shape == (3, 32, 32, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)

    for shared in (None, (np.array([30, 0, 12]), np.array([2, 40, 7]))):
        same_draw(images.sample_image_augment_params(np.random.default_rng(4), 3, 48, 32, 40,
                                                     shared_crop_origin=shared),
                  jax_images.sample_image_augment_params(np.random.default_rng(4), 3, 48, 32, 40,
                                                         shared_crop_origin=shared))


def test_training_clis_on_synthetic_data(tmp_path, monkeypatch):
    """Both CLIs' synthetic 1-epoch runs on the CPU (tiny models: the stage drivers'
    loaders patched as in test_torch_port_train_stages): their checkpoints hold the
    layouts the JAX package's loaders read. The JAX-blocked import check in
    test_torch_port_slice.py covers the CLIs' modules."""
    from test_torch_port_train_stages import _tiny_loaders

    from ted_spad_tpu_torch import train_action, train_reconstruction

    _tiny_loaders(monkeypatch)
    common = ["--synthetic", "--device", "cpu", "--epochs", "1", "--save_dir", str(tmp_path)]
    fa = train_reconstruction.run(train_reconstruction.parser().parse_args(common))
    ft = train_action.run(train_action.parser().parse_args(common))
    fa_tree = jax_load_checkpoint(fa["best_path"])["fa_model_state_dict"]
    ft_tree = jax_load_checkpoint(ft["best_path"])["ft_model_state_dict"]
    assert len(fa["history"]["train_loss"]) == len(ft["history"]["train_loss"]) == 1
    assert fa_tree["params"]["head"]["kernel"].shape == (3, 3, 8, 3)
    assert ft_tree["params"]["i3d"]["fc"]["kernel"].shape == (256, 4)
    assert ft_tree["batch_stats"]["mlp"]["bn2"]["var"].shape == (128,)
