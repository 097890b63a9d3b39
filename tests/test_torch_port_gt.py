"""Port parity of the frame-level gt builders (ted_spad_tpu_torch/data/gt_builders.py)
and of ``python -m ted_spad_tpu_torch.make_gt`` against the JAX package's
(ted_spad_tpu/data/gt_builders.py, scripts/make_gt.py), on synthetic events, masks and
spans from a numpy seed, and on annotation files the tests write: a UCF ``.mat``
(``scipy.io.savemat``), ST ``.npy`` masks and an XD ``.txt``. The arrays must be equal."""

import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import savemat

from ted_spad_tpu.data import gt_builders as jax_gt
from ted_spad_tpu_torch import make_gt
from ted_spad_tpu_torch.data import gt_builders as gt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events(rng, num_frames: int, n: int):
    cuts = np.sort(rng.choice(np.arange(1, num_frames - 1), 2 * n, replace=False))
    return [(int(a), int(b)) for a, b in zip(cuts[::2], cuts[1::2])]


@pytest.mark.parametrize("seed", range(4))
def test_ucf_builder_matches_jax(seed):
    rng = np.random.default_rng(seed)
    nf = 32 * int(rng.integers(3, 12))
    cases = [None, [], _events(rng, nf, 1), _events(rng, nf, 2),
             [(5, nf + 10)],  # past the end: [start, end), trailing normal span skipped
             [(nf - 40, nf + 3)]]  # a remainder under 64, trimmed
    for events in cases:
        np.testing.assert_array_equal(gt.ucf_video_gt(nf, events), jax_gt.ucf_video_gt(nf, events))
    for build in (gt.ucf_video_gt, jax_gt.ucf_video_gt):  # a remainder of 64 or more raises
        with pytest.raises(ValueError, match="remainder"):
            build(nf, [(nf // 2, nf + 70)])


@pytest.mark.parametrize("seed", range(3))
def test_shanghai_builder_matches_jax(seed):
    rng = np.random.default_rng(seed)
    nf = 16 * int(rng.integers(2, 8))
    for mask in (None, rng.integers(0, 2, 2 * nf - 2), rng.integers(0, 2, 2 * nf),
                 rng.integers(0, 2, nf)):
        np.testing.assert_array_equal(gt.shanghai_video_gt(nf, mask),
                                      jax_gt.shanghai_video_gt(nf, mask))
    for build in (gt.shanghai_video_gt, jax_gt.shanghai_video_gt):
        with pytest.raises(ValueError, match="frame mask length"):
            build(nf, np.ones(2 * nf + 4))


@pytest.mark.parametrize("seed", range(3))
def test_xd_builder_and_parser_match_jax(seed):
    rng = np.random.default_rng(seed)
    nf = 32 * int(rng.integers(3, 10))
    for spans in (None, _events(rng, nf, 1), _events(rng, nf, 3), [(3, nf + 9)]):
        np.testing.assert_array_equal(gt.xd_video_gt(nf, spans), jax_gt.xd_video_gt(nf, spans))
    line = "v=abc__#1_label_B2-0-0 12 40 88 130"
    assert gt.parse_xd_annotation_line(line) == jax_gt.parse_xd_annotation_line(line)


def test_build_gt_matches_jax():
    rng = np.random.default_rng(9)
    videos = {
        "UCF": [{"num_clips": 4, "events": [(10, 50)]}, {"num_clips": 3}],
        "ST": [{"num_clips": 5, "frame_mask": rng.integers(0, 2, 150)}, {"num_clips": 2}],
        "XD": [{"num_clips": 3}, {"num_clips": 4, "spans": [(0, 20), (60, 200)]}],
    }
    for dataset, vids in videos.items():
        np.testing.assert_array_equal(gt.build_gt(vids, dataset), jax_gt.build_gt(vids, dataset))
    np.testing.assert_array_equal(gt.build_gt(videos["UCF"], "UCF", frames_per_clip=16),
                                  jax_gt.build_gt(videos["UCF"], "UCF", frames_per_clip=16))


def _feature_file(d, name: str, clips: int) -> str:
    path = os.path.join(d, name + ".npy")
    np.save(path, np.zeros((clips, 4), np.float32))
    return path


def _write_list(d, paths) -> str:
    path = os.path.join(d, "test.list")
    with open(path, "w") as f:
        f.write("\n".join(paths) + "\n")
    return path


def _jax_make_gt(argv, monkeypatch) -> np.ndarray:
    sys.path.insert(0, ROOT)
    from scripts import make_gt as jax_make_gt

    monkeypatch.setattr(sys, "argv", ["make_gt.py", *argv])
    jax_make_gt.main()
    return np.load(argv[argv.index("--out") + 1])


def _both(argv, tmp_path, monkeypatch) -> tuple[np.ndarray, np.ndarray]:
    ours = make_gt.run(make_gt.parser().parse_args(argv + ["--out", str(tmp_path / "port.npy")]))
    assert np.array_equal(np.load(tmp_path / "port.npy"), ours)
    return ours, _jax_make_gt(argv + ["--out", str(tmp_path / "jax.npy")], monkeypatch)


def test_make_gt_ucf_matches_jax(tmp_path, monkeypatch):
    ann = tmp_path / "ann"
    ann.mkdir()
    savemat(str(ann / "Arrest001_x264.mat"), {"Annotation_file": {"Anno": np.array([[30, 90]])}})
    savemat(str(ann / "Fighting003_x264.mat"),
            {"Annotation_file": {"Anno": np.array([[10, 40], [100, 150]])}})
    paths = [_feature_file(tmp_path, "Arrest001_x264", 4), _feature_file(tmp_path, "Fighting003_x264", 6),
             _feature_file(tmp_path, "Normal_Videos_003_x264", 3)]
    argv = ["--dataset", "UCF", "--test_list", _write_list(tmp_path, paths),
            "--annotations_dir", str(ann)]
    ours, ref = _both(argv, tmp_path, monkeypatch)
    assert len(ours) == 32 * 13 and ours.sum() == 61 + 31 + 51
    np.testing.assert_array_equal(ours, ref)


def test_make_gt_st_matches_jax(tmp_path, monkeypatch):
    ann = tmp_path / "masks"
    ann.mkdir()
    rng = np.random.default_rng(3)
    paths = []
    for i, clips in enumerate((3, 5, 2)):
        paths.append(_feature_file(tmp_path, f"01_00{i}", clips))
        np.save(ann / f"01_00{i}.npy", rng.integers(0, 2, 32 * clips - 6))
    argv = ["--dataset", "ST", "--test_list", _write_list(tmp_path, paths), "--annotations_dir", str(ann)]
    ours, ref = _both(argv, tmp_path, monkeypatch)
    assert len(ours) == 16 * 10
    np.testing.assert_array_equal(ours, ref)


def test_make_gt_xd_matches_jax_and_refuses_an_ambiguous_match(tmp_path, monkeypatch):
    """The first 300 videos are normal; after them a video takes the line of its exact
    name, else the one line whose name holds it; two such lines raise."""
    normal = _feature_file(tmp_path, "normal", 2)
    named = [_feature_file(tmp_path, name, clips) for name, clips in
             (("vidA", 3), ("vidB_label_B1", 2), ("vidC", 4))]
    txt = tmp_path / "annotations.txt"
    txt.write_text("vidA 5 40\nvidA_long 0 90\nvidB_label_B1_full 10 20 30 50\nvidC 0 12 100 140\n")
    argv = ["--dataset", "XD", "--test_list", _write_list(tmp_path, [normal] * 300 + named),
            "--annotations_txt", str(txt)]
    ours, ref = _both(argv, tmp_path, monkeypatch)
    assert len(ours) == 32 * (600 + 9) and ours[: 32 * 600].sum() == 0
    assert ours[32 * 600 :].sum() == 35 + (10 + 20) + (12 + 28)  # vidC's second span clipped to 128
    np.testing.assert_array_equal(ours, ref)

    txt.write_text("vidA 5 40\nvidB_label_B1_full 10 20\nvidB_label_B1_cut 0 5\nvidC 0 12\n")
    for run in (lambda: make_gt.run(make_gt.parser().parse_args(argv + ["--out", str(tmp_path / "x.npy")])),
                lambda: _jax_make_gt(argv + ["--out", str(tmp_path / "y.npy")], monkeypatch)):
        with pytest.raises(SystemExit, match="ambiguous XD annotation match for 'vidB_label_B1'"):
            run()
    txt.write_text("vidA 5 40\nvidC 0 12\n")
    with pytest.raises(SystemExit, match="no XD annotation line matches 'vidB_label_B1'"):
        make_gt.run(make_gt.parser().parse_args(argv + ["--out", str(tmp_path / "z.npy")]))
