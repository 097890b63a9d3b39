"""The port's own decode layer (csrc/videodec.cpp, bound by data/video_reader.py), on
the CPU: its binding loads the library it builds, not the JAX package's
native/videodec; native-size RGB reads at widths that 16 does not divide repeat byte
for byte and are right in the tail columns (the JAX package's reads there are
neither, so the port deviates from them on purpose); at 16-aligned widths and at
reads scaled to 320x240 the bytes are the JAX package's; planar YUV reads at such a
width repeat, through the copy path (mp4, yuv420p) and the swscale path (y4m, 4:4:4).
Skips where FFmpeg's libraries do not build."""

from __future__ import annotations

import os

import numpy as np
import pytest

from ted_spad_tpu.data import video_reader as jax_vr
from ted_spad_tpu_torch.data import video_reader as vr

pytestmark = pytest.mark.skipif(
    not (vr.native_available() and jax_vr.native_available()),
    reason="FFmpeg's libraries do not build here")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEIGHT, FRAMES, READS = 48, 6, 3


def _frames(width: int, height: int = HEIGHT, seed: int = 1) -> np.ndarray:
    """Gradients in three directions plus noise: every column carries its own values,
    so a wrong column shows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    out = []
    for i in range(FRAMES):
        rgb = np.stack([(xx * 5 + i * 7) % 256, (yy * 7 + i * 3) % 256,
                        ((xx + yy) * 3 + i * 11) % 256], -1).astype(np.float64)
        out.append(np.clip(rgb + rng.normal(0, 4, rgb.shape), 0, 255).astype(np.uint8))
    return np.stack(out)


def _reads(path: str, out_w: int = 0, out_h: int = 0, reader=vr) -> list[np.ndarray]:
    reads = []
    for _ in range(READS):
        with reader.VideoReader(path, out_w, out_h) as v:
            reads.append(v.read_strided(0, FRAMES, 1))
    return reads


def test_the_binding_loads_the_ports_own_library():
    lib = vr._load_library()
    path = os.path.realpath(lib._name)
    assert path == os.path.realpath(vr.library_path())
    assert path.startswith(os.path.join(REPO, "build", "ted_spad_tpu_torch") + os.sep)
    assert os.path.basename(path).startswith("libvideodec-")
    assert not path.startswith(os.path.join(REPO, "native") + os.sep)


@pytest.mark.parametrize("width", [66, 72])
def test_native_reads_at_widths_16_does_not_divide_repeat_and_are_right(tmp_path, width):
    """Three reads give the same bytes (the shared library's differ, or abort at 72),
    and the columns past the last multiple of 16 sit within 2x the interior's mean
    error from the frames written (the shared library's sat ≈ 10x: 104 against 11)."""
    frames = _frames(width)
    path = vr.write_mp4(str(tmp_path / f"w{width}.mp4"), frames, fps=25)
    reads = _reads(path)
    assert reads[0].shape == (FRAMES, HEIGHT, width, 3)
    for other in reads[1:]:
        np.testing.assert_array_equal(other, reads[0])
    err = np.abs(reads[0].astype(np.int64) - frames).mean(axis=(0, 1, 3))
    edge = width // 16 * 16
    interior, tail = err[:edge].mean(), err[edge:].mean()
    assert interior < 16, interior  # H.264 at crf 18 over noisy gradients
    assert tail <= 2 * interior, (tail, interior)


@pytest.mark.parametrize("size,out_wh", [
    ((48, 64), (0, 0)), ((240, 320), (0, 0)), ((48, 66), (320, 240)), ((48, 72), (320, 240)),
    ((240, 320), (320, 240)),
], ids=["64x48", "320x240", "66x48-to-320x240", "72x48-to-320x240", "320x240-to-320x240"])
def test_aligned_and_scaled_reads_equal_the_jax_packages(tmp_path, size, out_wh):
    h, w = size
    path = vr.write_mp4(str(tmp_path / f"v{w}.mp4"), _frames(w, h, seed=2), fps=25)
    ours = _reads(path, *out_wh)
    theirs = _reads(path, *out_wh, reader=jax_vr)
    want = (FRAMES, out_wh[1] or h, out_wh[0] or w, 3)
    assert ours[0].shape == theirs[0].shape == want
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("container", ["mp4", "y4m"])
def test_planar_reads_at_66_wide_repeat(tmp_path, container):
    """mp4 decodes to yuv420p and is copied row by row; the y4m is 4:4:4, so its planes
    go through swscale into the aligned buffers (33-byte chroma rows). Both repeat, and
    the y4m's planes are the JAX package's bytes (that branch was stable there too)."""
    frames = _frames(66)
    write = vr.write_mp4 if container == "mp4" else vr.write_y4m
    path = write(str(tmp_path / f"p.{container}"), frames)
    planes = []
    for reader in (vr, vr, vr, jax_vr):
        with reader.VideoReader(path) as v:
            planes.append(v.read_strided_yuv(0, FRAMES, 1))
    y, u, v, _ = planes[0]
    assert y.shape == (FRAMES, HEIGHT, 66) and u.shape == v.shape == (FRAMES, HEIGHT // 2, 33)
    for other in planes[1:3] + (planes[3:] if container == "y4m" else []):
        for a, b in zip(planes[0][:3], other[:3]):
            np.testing.assert_array_equal(a, b)
    luma = frames.astype(np.float64) @ np.array([0.299, 0.587, 0.114])
    if container == "y4m":  # full-range BT.601, as write_y4m encodes it
        assert np.abs(y - luma).mean() < 1
