"""Benchmark video fixtures for decode-throughput measurement (counterpart of
ted_spad_tpu/utils/bench_videos.py, numpy only).

A set of unique, varied H.264 videos with realistic coding complexity: per-video
random scene seeds, mixed resolutions including 480p (UCF-Crime is 240-480p H.264)
and two files of more than 1000 frames, and scenes x264 codes like natural video --
textured moving sprites over a drifting background plus low-amplitude sensor noise.
Pure noise would time the entropy coder's worst case and pure gradients its best.

The frames are bit-equal to the JAX package's for any ``(seed, width, height, t0,
t1)``: the same ``default_rng`` draws in the same order, the same float32
arithmetic, the noise generator seeded per chunk. The files go through the port's
own encoder (``data/video_reader.VideoWriter``) into
``<root>/<spec-tag>/bv{idx:02d}_{w}x{h}x{f}.mp4``, each marked done by a ``.ok``
file and the set by ``DONE``, so the one-time encode is paid once per directory.
"""

from __future__ import annotations

import os

import numpy as np

# (count, width, height, frames): 32 unique videos in all.
FULL_SPEC = ((20, 320, 240, 300), (8, 640, 480, 300), (2, 854, 480, 1000), (2, 320, 240, 1100))
# The smaller set, for when the full one cannot be afforded.
REDUCED_SPEC = ((12, 320, 240, 300), (4, 640, 480, 300))

CHUNK_FRAMES = 100  # frames synthesized at once: 480p x 1000 frames would be > 1 GB raw


def _spec_tag(spec) -> str:
    return "s" + "_".join(f"{c}x{w}x{h}x{f}" for c, w, h, f in spec)


def _spec_paths(root: str, spec) -> list[str]:
    """The set's video paths, in index order."""
    out_dir = os.path.join(root, _spec_tag(spec))
    paths = []
    for count, w, h, f in spec:
        for _ in range(count):
            paths.append(os.path.join(out_dir, f"bv{len(paths):02d}_{w}x{h}x{f}.mp4"))
    return paths


def synth_scene_frames(seed: int, width: int, height: int, t0: int, t1: int) -> np.ndarray:
    """Frames [t0, t1) of a deterministic synthetic scene: drifting textured
    background + 5 moving textured sprites + mild sensor noise. Returns
    (t1-t0, H, W, 3) uint8."""
    rng = np.random.default_rng(seed)
    n_sprites = 5
    # Per-scene draws, independent of the frame range asked for.
    tex_h, tex_w = height // 4, width // 4
    textures = rng.integers(40, 216, (n_sprites, tex_h, tex_w, 3), dtype=np.uint8)
    sp_w = rng.integers(width // 8, width // 3, n_sprites)
    sp_h = rng.integers(height // 8, height // 3, n_sprites)
    sx0 = rng.uniform(0, width, n_sprites)
    sy0 = rng.uniform(0, height, n_sprites)
    svx = rng.uniform(-3.0, 3.0, n_sprites)
    svy = rng.uniform(-2.0, 2.0, n_sprites)
    bg_phase = rng.uniform(0, 2 * np.pi, 2)
    pan = rng.uniform(-1.5, 1.5, 2)
    noise_seed = int(rng.integers(0, 2**31))

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    out = np.empty((t1 - t0, height, width, 3), np.uint8)
    nrng = np.random.default_rng(noise_seed + t0)  # noise decorrelated per chunk
    for i, t in enumerate(range(t0, t1)):
        # Smooth drifting background (camera pan).
        bx, by = xx + pan[0] * t, yy + pan[1] * t
        bg = (
            110
            + 55 * np.sin(bx / 97 + bg_phase[0] + t / 240.0)
            + 45 * np.cos(by / 71 + bg_phase[1])
        )
        frame = np.repeat(bg[..., None], 3, axis=-1)
        frame[..., 1] *= 0.92  # mild colour cast so the planes differ
        frame[..., 2] *= 0.85
        for s in range(n_sprites):
            # The sprite bounces inside the frame.
            px = sx0[s] + svx[s] * t
            py = sy0[s] + svy[s] * t
            w_s, h_s = int(sp_w[s]), int(sp_h[s])
            px = int(abs(px) % max(2 * (width - w_s), 1))
            py = int(abs(py) % max(2 * (height - h_s), 1))
            if px > width - w_s:
                px = 2 * (width - w_s) - px
            if py > height - h_s:
                py = 2 * (height - h_s) - py
            tex = textures[s]
            tile = np.tile(tex, ((h_s + tex_h - 1) // tex_h, (w_s + tex_w - 1) // tex_w, 1))
            frame[py : py + h_s, px : px + w_s] = tile[:h_s, :w_s]
        frame += nrng.normal(0.0, 5.0, frame.shape).astype(np.float32)
        out[i] = np.clip(frame, 0, 255).astype(np.uint8)
    return out


def generate_fixture_set(root: str = ".bench_videos", spec=FULL_SPEC, fps: float = 25.0,
                         log_fn=None) -> list[str]:
    """Generate (or reuse) the fixture set; returns the list of video paths.

    Idempotent: a finished set (its ``DONE`` marker) is returned without encoding,
    and a video with its ``.ok`` marker is not encoded again. Where the native
    encoder cannot load, ``VideoWriter`` raises its error."""
    from ted_spad_tpu_torch.data.video_reader import VideoWriter

    paths = _spec_paths(root, spec)
    out_dir = os.path.join(root, _spec_tag(spec))
    done = os.path.join(out_dir, "DONE")
    if os.path.exists(done):
        return paths
    os.makedirs(out_dir, exist_ok=True)
    sizes = [(w, h, f) for count, w, h, f in spec for _ in range(count)]
    for idx, (path, (w, h, f)) in enumerate(zip(paths, sizes)):
        if os.path.exists(path + ".ok"):
            continue
        with VideoWriter(path, w, h, fps=fps) as vw:
            for t0 in range(0, f, CHUNK_FRAMES):
                for frame in synth_scene_frames(idx, w, h, t0, min(t0 + CHUNK_FRAMES, f)):
                    vw.write(frame)
        with open(path + ".ok", "w") as fh:
            fh.write("ok")
        if log_fn:
            log_fn(f"bench_videos: encoded {os.path.basename(path)}")
    with open(done, "w") as fh:
        fh.write(_spec_tag(spec))
    return paths
