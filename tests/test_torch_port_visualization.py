"""Parity of the port's visualization stage (4.5) and encoder binding with ted_spad_tpu's,
on the CPU: ``write_y4m`` byte for byte; ``VideoWriter`` / ``write_mp4`` files read by the
other package's decoder; ``anonymize_video`` from the same weights (full-width UNet++ and
UNet fa, float32) on a synthetic video, through the mp4 branch and, with the native
library hidden in both packages, the y4m branch; the port's PNG writer; ``out_name`` and
the CLI. (K2's float32 form at the visualization chunk's shapes is a card-only test of
test_torch_port_kernels.py.) Torch on one thread."""

from __future__ import annotations

import functools
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ted_spad_tpu.data import video_reader as jax_vr
from ted_spad_tpu.stages import visualization as jax_vis
from ted_spad_tpu_torch import visualize_anonymization
from ted_spad_tpu_torch.data import video_reader as vr
from ted_spad_tpu_torch.models import load_fa_model
from ted_spad_tpu_torch.stages import visualization as vis
from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax

torch.set_num_threads(1)

URI = "synthetic://n=24,h=48,w=64,seed=0"
SIZE = (48, 64)



@pytest.fixture()
def native():
    if not (vr.native_available() and jax_vr.native_available()):
        pytest.skip("the native videodec library does not build here")


needs_native = pytest.mark.usefixtures("native")


def _frames(t: int, h: int, w: int, seed: int) -> np.ndarray:
    """Smooth moving colour gradients with noise: content a video codec keeps well."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.stack([np.stack([(xx * 3 + 7 * i) % 256, (yy * 4 + 5 * i) % 256,
                              np.full_like(xx, (40 * i) % 256)], -1) for i in range(t)])
    return np.clip(out + rng.integers(-6, 7, out.shape), 0, 255).astype(np.uint8)


def _decode(path: str, reader) -> np.ndarray:
    with reader.VideoReader(path) as v:
        return v.read_strided(0, len(v), 1)


@needs_native
def test_write_y4m_is_byte_equal_to_jax(tmp_path):
    frames = _frames(5, 31, 45, seed=1)  # odd sizes: C444 needs no cropping
    a = vr.write_y4m(str(tmp_path / "p.y4m"), frames, fps=30)
    b = jax_vr.write_y4m(str(tmp_path / "j.y4m"), frames, fps=30)
    assert open(a, "rb").read() == open(b, "rb").read()
    with vr.Y4MWriter(str(tmp_path / "s.y4m"), 45, 31, fps=30) as w:
        for f in frames:
            w.write(f)
        with pytest.raises(ValueError, match="not the writer's"):
            w.write(frames[0, :30])
    assert open(tmp_path / "s.y4m", "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(_decode(a, vr), _decode(b, jax_vr))


@needs_native
@pytest.mark.parametrize("colorspace", [0, 601, 709])
def test_mp4_written_by_one_package_decodes_in_the_other(tmp_path, colorspace):
    """The same frames through the port's write_mp4 and JAX's: the two files are the
    same bytes, each decoded by the other package's reader gives the frames the other
    package's file gives, and those stay near the input (H.264 is lossy). The frames
    are 48x64 plus one odd row and column, which both writers crop. (A width that 16
    does not divide is not decoded here: the JAX package's decoder reads such a stream
    nondeterministically, and corrupts the heap at 72. The port's own decoder reads it
    right; test_torch_port_videodec.py holds that.)"""
    frames = _frames(6, 49, 65, seed=2)
    ours = vr.write_mp4(str(tmp_path / "p.mp4"), frames, fps=25, colorspace=colorspace)
    theirs = jax_vr.write_mp4(str(tmp_path / "j.mp4"), frames, fps=25, colorspace=colorspace)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    a, b = _decode(ours, jax_vr), _decode(theirs, vr)
    assert a.shape == b.shape == (6, 48, 64, 3)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a.astype(int) - frames[:, :48, :64]).mean() < 8
    with vr.VideoReader(ours) as v:
        assert v.colorspace == (colorspace or 0) and abs(v.fps - 25) < 1e-6


@needs_native
def test_video_writer_refuses_what_it_cannot_encode(tmp_path):
    with pytest.raises(ValueError, match="colorspace"):
        vr.VideoWriter(str(tmp_path / "x.mp4"), 64, 48, colorspace=2020)
    with vr.VideoWriter(str(tmp_path / "x.mp4"), 65, 49) as w:
        assert (w.height, w.width) == (48, 64)
        w.write(np.zeros((49, 65, 3), np.uint8))  # larger frames are cropped
        for bad in (np.zeros((47, 64, 3), np.uint8), np.zeros((48, 64), np.uint8)):
            with pytest.raises(ValueError, match="does not fit"):
                w.write(bad)


def test_png_writer_reads_back_in_pil(tmp_path):
    rgb = np.random.default_rng(3).integers(0, 256, (37, 53, 3)).astype(np.uint8)
    path = vis.write_png(str(tmp_path / "g.png"), rgb)
    img = Image.open(path)
    assert img.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(img), rgb)


@functools.lru_cache(maxsize=None)
def _fa(arch: str):
    """The port's seeded full-width fa and the same weights as a flax tree. The UNet's
    ``outc`` is drawn 8x wider, as chip_smoke.py's: its random-init sigmoid output
    otherwise sits at 0.5 +- 0.02. (Perturbed BN statistics, as the step tests use,
    blow the UNet++'s output up to +-2e4, where float32 rounding alone moves the
    clipped frames by 8 levels.)"""
    fa = load_fa_model(arch, dtype="float32", device="cpu")
    if arch == "unet":
        with torch.no_grad():
            fa.outc.weight.mul_(8.0)
    return fa, state_dict_to_flax(fa)


def _both(arch: str, tmp_path, monkeypatch, native: bool = True):
    """anonymize_video in each package on URI from the same weights: ({paths}, {paths})."""
    fa, tree = _fa(arch)
    if not native:
        monkeypatch.setattr(vis, "native_available", lambda: False)
        monkeypatch.setattr(jax_vis, "native_available", lambda: False)
    logs = []
    ours = vis.anonymize_video(URI, str(tmp_path / "p"), fa=fa, size=SIZE, chunk=10, log_fn=logs.append)
    theirs = jax_vis.anonymize_video(URI, str(tmp_path / "j"), fa_variables=tree, arch_fa=arch, size=SIZE,
                                     chunk=10)
    assert len(logs) == 1 and ("mp4" if native else "y4m") in logs[0]
    return ours, theirs


def _grid(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB")).astype(int)


@needs_native
@pytest.mark.parametrize("arch", ["unet++", "unet"])
def test_anonymize_video_matches_jax(arch, tmp_path, monkeypatch):
    """The mp4 branch (BT.601-tagged): the same file names; the grids' original rows
    equal and their anonymized rows within 1 uint8 level (and not the input); each
    decoded video near its own grid's anonymized frames (mean |d| < 16 levels, the JAX
    stage test's limit, tests/test_visualization_stage.py:33) and the two decoded
    videos within a mean of 4 levels, under a third of the codec's own mean error on
    these frames (13.7). The encoder is not held to 1 level: the packages' frames differ
    by one level in 0.014% of values, and one such flip alone moves x264's decoded
    output by a mean of 1.2 levels (44 at most)."""
    ours, theirs = _both(arch, tmp_path, monkeypatch)
    assert {k: os.path.basename(v) for k, v in ours.items()} == \
        {k: os.path.basename(v) for k, v in theirs.items()} == \
        {"video": "n24_h48_w64_seed0_anon.mp4", "grid": "n24_h48_w64_seed0_grid.png"}
    a, b = _grid(ours["grid"]), _grid(theirs["grid"])
    h, w = SIZE
    assert a.shape == b.shape == (2 * h, 4 * w, 3)
    np.testing.assert_array_equal(a[:h], b[:h])
    assert np.abs(a[h:] - b[h:]).max() <= 1
    assert np.abs(a[h:] - a[:h]).mean() > 4
    va, vb = _decode(ours["video"], vr).astype(int), _decode(theirs["video"], vr).astype(int)
    assert va.shape == vb.shape == (24,) + SIZE + (3,)
    idx = np.linspace(0, 23, 4).astype(int)
    for video, grid in ((va, a), (vb, b)):
        assert np.abs(np.concatenate(list(video[idx]), axis=1) - grid[h:]).mean() < 16
    assert np.abs(va - vb).mean() < 4
    with vr.VideoReader(ours["video"]) as v:
        assert v.colorspace == 601


@needs_native
def test_anonymize_video_y4m_branch_matches_jax(tmp_path, monkeypatch):
    """Without the native library (hidden in both packages) the stage writes y4m, said
    in its log line: both files hold the same header and frames within 1 level."""
    ours, theirs = _both("unet++", tmp_path, monkeypatch, native=False)
    assert ours["video"].endswith("_anon.y4m") and theirs["video"].endswith("_anon.y4m")
    a, b = open(ours["video"], "rb").read(), open(theirs["video"], "rb").read()
    header = a.split(b"\n", 1)[0]
    assert header == b.split(b"\n", 1)[0] == b"YUV4MPEG2 W64 H48 F30:1 Ip A1:1 C444 XCOLORRANGE=FULL"
    assert len(a) == len(b)
    assert np.abs(np.frombuffer(a, np.uint8).astype(int) - np.frombuffer(b, np.uint8)).max() <= 1


@needs_native
def test_out_name_and_the_cli(tmp_path):
    """``out_name`` sets the stem; the CLI's --synthetic run writes both artifacts, and
    over a glob of two same-basename videos in different directories it gives them
    distinct stems (utils.naming.dedup_names)."""
    fa, _ = _fa("unet++")
    got = vis.anonymize_video("synthetic://n=3,h=32,w=32,seed=1", str(tmp_path / "o"), fa=fa, size=(32, 32),
                              out_name="cam_a", log_fn=lambda m: None)
    assert sorted(os.listdir(tmp_path / "o")) == ["cam_a_anon.mp4", "cam_a_grid.png"]
    assert got["grid"].endswith("cam_a_grid.png")

    out = visualize_anonymization.run(visualize_anonymization.parser().parse_args(
        ["--synthetic", "--device", "cpu", "--out_dir", str(tmp_path / "cli")]))
    (paths,) = out.values()
    assert all(os.path.exists(p) for p in paths.values())
    assert _grid(paths["grid"]).shape == (96, 256, 3)

    for d in ("a", "b"):
        os.makedirs(tmp_path / "v" / d)
        vr.write_mp4(str(tmp_path / "v" / d / "cam.mp4"), _frames(2, 240, 320, seed=4))
    out = visualize_anonymization.run(visualize_anonymization.parser().parse_args(
        ["--videos_glob", str(tmp_path / "v" / "*" / "cam.mp4"), "--device", "cpu",
         "--out_dir", str(tmp_path / "glob")]))
    stems = sorted(os.path.basename(p["video"]) for p in out.values())
    assert len(set(stems)) == 2 and all(s.startswith("cam_") and s.endswith("_anon.mp4") for s in stems)

