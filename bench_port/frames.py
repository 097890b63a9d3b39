"""Synthetic surveillance-like frames, made on the device from a seed.

The arithmetic of the port's fixture scenes (``utils/bench_videos.synth_scene_frames``:
a drifting sinusoidal background with a colour cast, five textured sprites bouncing
inside the frame, Gaussian sensor noise of sigma 5), vectorised in torch over a
chunk of frames at a time, so a pool of some thousand frames takes well under a
second on the card where the numpy original takes 8.4 ms a frame on its host.
"""

from __future__ import annotations

import numpy as np
import torch

N_SPRITES = 5


def _bounce(p0: np.ndarray, v: np.ndarray, t: np.ndarray, span: int, size: int) -> np.ndarray:
    """Top-left coordinate of a sprite bouncing in [0, span - size] at each time t."""
    p = np.abs(p0 + v * t).astype(np.int64) % max(2 * (span - size), 1)
    return np.where(p > span - size, 2 * (span - size) - p, p)


def scene_frames(seed: int, n: int, height: int, width: int, device,
                 t0: int = 0) -> torch.Tensor:
    """Frames [t0, t0 + n) of the scene drawn from ``seed``: (n, H, W, 3) uint8 on
    ``device``."""
    rng = np.random.default_rng(seed)
    tex_h, tex_w = height // 4, width // 4
    g = torch.Generator(device=device).manual_seed(int(rng.integers(0, 2**62)))
    noise = torch.Generator(device=device).manual_seed(int(rng.integers(0, 2**62)) + t0)
    textures = torch.randint(40, 216, (N_SPRITES, tex_h, tex_w, 3), generator=g,
                             device=device, dtype=torch.int32).float()
    sp_w = rng.integers(width // 8, width // 3, N_SPRITES)
    sp_h = rng.integers(height // 8, height // 3, N_SPRITES)
    sx0, sy0 = rng.uniform(0, width, N_SPRITES), rng.uniform(0, height, N_SPRITES)
    svx, svy = rng.uniform(-3.0, 3.0, N_SPRITES), rng.uniform(-2.0, 2.0, N_SPRITES)
    phase, pan = rng.uniform(0, 2 * np.pi, 2), rng.uniform(-1.5, 1.5, 2)

    t_host = np.arange(t0, t0 + n, dtype=np.float64)
    t = torch.arange(t0, t0 + n, device=device, dtype=torch.float32)[:, None, None]
    yy = torch.arange(height, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(width, device=device, dtype=torch.float32)[None, None, :]
    bg = (110 + 55 * torch.sin((xx + float(pan[0]) * t) / 97 + float(phase[0]) + t / 240.0)
          + 45 * torch.cos((yy + float(pan[1]) * t) / 71 + float(phase[1])))  # (n, H, W)
    cast = torch.tensor([1.0, 0.92, 0.85], device=device)
    frame = bg[..., None] * cast
    yi = torch.arange(height, device=device)[None, :, None]
    xi = torch.arange(width, device=device)[None, None, :]
    for s in range(N_SPRITES):
        w_s, h_s = int(sp_w[s]), int(sp_h[s])
        px = torch.from_numpy(_bounce(sx0[s], svx[s], t_host, width, w_s)).to(device)
        py = torch.from_numpy(_bounce(sy0[s], svy[s], t_host, height, h_s)).to(device)
        px, py = px[:, None, None], py[:, None, None]
        inside = (yi >= py) & (yi < py + h_s) & (xi >= px) & (xi < px + w_s)  # (n, H, W)
        tex = textures[s][(yi - py) % tex_h, (xi - px) % tex_w]  # (n, H, W, 3)
        frame = torch.where(inside[..., None], tex, frame)
    frame = frame + 5.0 * torch.randn(frame.shape, generator=noise, device=device)
    return frame.clamp_(0, 255).to(torch.uint8)


def frame_pool(seed: int, n_frames: int, height: int, width: int, device,
               scenes: int, chunk: int = 64) -> torch.Tensor:
    """``scenes`` scenes of ``n_frames // scenes`` consecutive frames each, drawn from
    ``seed``, in host memory: (n_frames, H, W, 3) uint8."""
    per = n_frames // scenes
    pool = torch.empty((per * scenes, height, width, 3), dtype=torch.uint8)
    rng = np.random.default_rng(seed)
    scene_seeds = rng.integers(0, 2**62, scenes)
    for s in range(scenes):
        for c0 in range(0, per, chunk):
            n = min(chunk, per - c0)
            frames = scene_frames(int(scene_seeds[s]), n, height, width, device, t0=c0)
            pool[s * per + c0:s * per + c0 + n].copy_(frames)
    return pool
