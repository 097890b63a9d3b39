"""The port's benchmark fixtures (utils/bench_videos.py, gen_bench_videos) against the
JAX package's, on the CPU: the synthetic scenes bit-equal for several seeds, sizes
and frame ranges (a chunk boundary included), the spec tags and path lists of both
specs, a tiny fixture set's paths and markers, the frames of both packages' files
through the port's decoder, idempotence (a finished set encodes nothing, a file
without its ``.ok`` is the only one encoded again), and the CLI's output lines.

The native encoder (the same C code in both packages) does not write the same file
from run to run: the first x264 encode of a process, and at widths 16 does not
divide the bytes past the caller's frame, change it (mpeg4's files are stable). So
the two packages' files are held by their decoded frames, within DECODE_MEAN_TOL
levels of mean |diff| (measured: up to 1.24 between the two packages' 66x48x12
files, 0.08 between repeated encodes in one package), each against its scene and
with another scene as the control."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import ted_spad_tpu.utils.bench_videos as jax_bv
from ted_spad_tpu_torch import gen_bench_videos
from ted_spad_tpu_torch.data import video_reader as vr
from ted_spad_tpu_torch.utils import bench_videos as bv

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SPEC = ((2, 66, 48, 12),)
DECODE_MEAN_TOL = 2.0  # levels, between two encodes of the same frames
SCENE_MEAN_TOL = 16.0  # levels, a decode against its scene (x264 at crf 18 measures 10.8-11.3)
CONTROL_MEAN_MIN = 40.0  # levels, a decode against the next seed's scene (measures 47-57)


@pytest.fixture
def encoder():
    """Skips where FFmpeg's libraries do not build; decided when a test asks."""
    if not vr.native_available():
        pytest.skip("FFmpeg's libraries do not build here")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("width,height,t0,t1", [(64, 48, 0, 3), (64, 48, 100, 103),
                                                (66, 48, 0, 3), (66, 48, 100, 103),
                                                (854, 480, 0, 1), (854, 480, 100, 101)])
def test_synth_scene_frames_bit_equal_jax(seed, width, height, t0, t1):
    ours = bv.synth_scene_frames(seed, width, height, t0, t1)
    ref = jax_bv.synth_scene_frames(seed, width, height, t0, t1)
    assert ours.dtype == ref.dtype == np.uint8 and ours.shape == (t1 - t0, height, width, 3)
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("spec", ["FULL_SPEC", "REDUCED_SPEC"])
def test_spec_tags_and_paths_equal_jax(tmp_path, spec):
    ours, ref = getattr(bv, spec), getattr(jax_bv, spec)
    assert ours == ref and bv._spec_tag(ours) == jax_bv._spec_tag(ref)
    lists = []
    for module, name in ((bv, "port"), (jax_bv, "jax")):
        root = tmp_path / name
        (root / module._spec_tag(ours)).mkdir(parents=True)
        (root / module._spec_tag(ours) / "DONE").write_text("done")  # a finished set: no encode
        lists.append([os.path.relpath(p, root) for p in module.generate_fixture_set(str(root), ours)])
    assert lists[0] == lists[1] and len(lists[0]) == sum(c for c, *_ in ours)
    assert len(set(lists[0])) == len(lists[0])


def _tree(root) -> dict:
    """Every file under ``root``, relative, with its text for the markers."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            out[os.path.relpath(path, root)] = (None if f.endswith(".mp4")
                                                else open(path).read())
    return out


def _decoded(path: str) -> np.ndarray:
    with vr.VideoReader(path) as reader:
        return reader.read_strided(0, len(reader), 1)


def _same_scene(frames: np.ndarray, ref: np.ndarray, seed: int) -> None:
    """Two decodes of scene ``seed`` agree, and follow that scene, not the next one."""
    frames = frames.astype(np.float32)
    assert np.abs(frames - ref).mean() <= DECODE_MEAN_TOL
    t, h, w, _ = frames.shape
    scene = bv.synth_scene_frames(seed, w, h, 0, t).astype(np.float32)
    control = bv.synth_scene_frames(seed + 1, w, h, 0, t).astype(np.float32)
    assert np.abs(frames - scene).mean() <= SCENE_MEAN_TOL
    assert np.abs(frames - control).mean() >= CONTROL_MEAN_MIN


def test_fixture_set_equals_jax_and_is_idempotent(tmp_path, encoder):
    logs = {"port": [], "jax": []}
    paths = {}
    for module, name in ((bv, "port"), (jax_bv, "jax")):
        root = str(tmp_path / name)
        paths[name] = module.generate_fixture_set(root, TINY_SPEC, log_fn=logs[name].append)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert [os.path.relpath(p, tmp_path / "port") for p in paths["port"]] == [
        os.path.relpath(p, tmp_path / "jax") for p in paths["jax"]]
    assert logs["port"] == logs["jax"] == [
        f"bench_videos: encoded {os.path.basename(p)}" for p in paths["port"]]
    for ours, ref, idx in zip(paths["port"], paths["jax"], range(2)):
        frames = _decoded(ours)
        assert frames.shape == (12, 48, 66, 3)
        _same_scene(frames, _decoded(ref), idx)

    # A finished set encodes nothing; a file without its .ok is the only one encoded.
    past = 1_000_000_000
    for p in paths["port"]:
        os.utime(p, (past, past))
    again = []
    assert bv.generate_fixture_set(str(tmp_path / "port"), TINY_SPEC, log_fn=again.append) == paths["port"]
    assert again == [] and all(os.stat(p).st_mtime == past for p in paths["port"])
    out_dir = os.path.dirname(paths["port"][0])
    os.remove(os.path.join(out_dir, "DONE"))
    os.remove(paths["port"][1] + ".ok")
    bv.generate_fixture_set(str(tmp_path / "port"), TINY_SPEC, log_fn=again.append)
    assert again == [f"bench_videos: encoded {os.path.basename(paths['port'][1])}"]
    assert os.stat(paths["port"][0]).st_mtime == past and os.stat(paths["port"][1]).st_mtime != past
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    _same_scene(_decoded(paths["port"][1]), _decoded(paths["jax"][1]), 1)


def test_cli_prints_what_the_jax_script_prints(tmp_path, monkeypatch, capsys, encoder):
    sys.path.insert(0, ROOT)
    import scripts.gen_bench_videos as jax_cli

    out = {}
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        with monkeypatch.context() as m:
            m.setattr(bv, "FULL_SPEC", TINY_SPEC)
            m.setattr(jax_bv, "FULL_SPEC", TINY_SPEC)
            if name == "port":
                gen_bench_videos.main([])
            else:
                m.setattr(sys, "argv", ["scripts/gen_bench_videos.py"])
                jax_cli.main()
        # Times differ from run to run; the lines' words must not.
        out[name] = [re.sub(r"[0-9.]+s\b", "<t>", line)
                     for line in capsys.readouterr().out.splitlines()]
    assert out["port"] == out["jax"]
    assert out["port"][-1] == "fixture set ready: 2 videos in <t>"
    assert os.listdir(tmp_path / "port" / ".bench_videos") == [bv._spec_tag(TINY_SPEC)]


def test_cli_help_runs_outside_the_repository(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "ted_spad_tpu_torch.gen_bench_videos", "--help"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    assert "--reduced" in proc.stdout and "16-video fallback set" in proc.stdout
