"""Anonymization visualization, stage 4.5: the fa over whole videos, written as a video
and a before/after grid (counterpart of ted_spad_tpu/stages/visualization.py;
reference visualization/visualize_anonymization.py, anonymize_videos :65).

Frames stream chunk by chunk: each decoded chunk goes through the fa on the card (a
plain-UNet fa runs its DoubleConvs through kernel K2) and straight to the writer, so
host memory stays O(chunk + grid samples) however long the video. The video is an
``.mp4`` through the native encoder (BT.601-tagged), or, where the native library is
not available, a ``.y4m`` written in numpy -- the JAX stage's own choice of
container, printed, never silent. The grid (original frames over anonymized ones) is
a PNG written with the standard library alone.
"""

from __future__ import annotations

import binascii
import os
import struct
import zlib
from typing import Callable

import numpy as np
import torch

from ted_spad_tpu_torch.data.video_reader import (
    VideoWriter, Y4MWriter, native_available, open_video,
)
from ted_spad_tpu_torch.models import load_fa_model
from ted_spad_tpu_torch.ops.fast_unetpp import make_fast_fa_apply
from ted_spad_tpu_torch.utils.device import tf32_off
from ted_spad_tpu_torch.utils.naming import base_name


def make_anonymize_fn(fa: torch.nn.Module) -> Callable[[np.ndarray], torch.Tensor]:
    """``anonymize(frames_u8 (N, H, W, 3)) -> (N, H, W, 3)`` float32 in [0, 1] on the
    fa's device: /255, the eval fa (in its weights' dtype, float32 convolutions with
    TF32 off; the UNet++ through its fused eval form, ``make_fast_fa_apply``), clip(0,
    1). Runs under ``inference_mode``."""
    device = next(fa.parameters()).device
    fast_fa = make_fast_fa_apply(fa)

    def anonymize(frames_u8) -> torch.Tensor:
        with torch.inference_mode(), tf32_off():
            img = torch.as_tensor(frames_u8).to(device).float() / 255.0
            out = fast_fa(img.permute(0, 3, 1, 2)).float()
            return out.clamp(0.0, 1.0).permute(0, 2, 3, 1)

    return anonymize


def write_png(path: str, rgb: np.ndarray) -> str:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG (zlib, one IDAT, no row filters)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes (H, W, 3) RGB, got {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", binascii.crc32(kind + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
    return path


def anonymize_video(
    video_uri: str,
    out_dir: str,
    *,
    fa: torch.nn.Module | None = None,
    saved_model_fa: str | None = None,
    arch_fa: str = "unet++",
    chunk: int = 32,
    size: tuple[int, int] = (240, 320),
    sample_grid_frames: int = 4,
    dtype: str = "float32",
    out_name: str | None = None,
    device: str | torch.device = "cuda",
    log_fn: Callable[[str], None] = print,
) -> dict[str, str]:
    """Write ``<name>_anon.mp4`` (``<name>_anon.y4m`` without the native library) and
    ``<name>_grid.png`` (``sample_grid_frames`` originals over their anonymized
    copies) under ``out_dir``; returns ``{"video": path, "grid": path}``.

    The fa is ``fa`` (a module, used on its own device) or ``load_fa_model(arch_fa,
    saved_model_file=saved_model_fa, dtype=dtype)`` on ``device``; float32 by
    default, as the JAX stage. ``size`` is the decode size (H, W). ``out_name``
    replaces the stem taken from the uri: give ``utils.naming.dedup_names`` stems when
    videos of one basename sit in different directories."""
    if fa is None:
        fa = load_fa_model(arch_fa, saved_model_file=saved_model_fa, dtype=dtype, device=device)
    anonymize = make_anonymize_fn(fa)
    os.makedirs(out_dir, exist_ok=True)
    h, w = size
    base = out_name or base_name(video_uri)
    vr = open_video(video_uri, w, h)
    n = len(vr)
    fps = vr.fps if getattr(vr, "fps", 0) else 25.0
    grid_idx = set(np.linspace(0, max(n - 1, 0), sample_grid_frames).astype(int).tolist())
    grid_orig: dict[int, np.ndarray] = {}
    grid_anon: dict[int, np.ndarray] = {}

    if native_available():
        video_path = os.path.join(out_dir, f"{base}_anon.mp4")
        # BT.601-tagged: players assume BT.709 for untagged HD streams, which shifts colours.
        writer = VideoWriter(video_path, w, h, fps=fps, colorspace=601)
        log_fn(f"visualization: {video_path} (mp4, native encoder)")
    else:
        video_path = os.path.join(out_dir, f"{base}_anon.y4m")
        # Sized by the frames themselves, as the JAX stage's write_y4m.
        writer = Y4MWriter(video_path, vr.width, vr.height, fps=int(round(fps)))
        log_fn(f"visualization: {video_path} (y4m: the native library is not available)")
    try:
        for start in range(0, n, chunk):
            count = min(chunk, n - start)
            frames = vr.read_strided(start, count, 1)
            anon_u8 = (anonymize(frames) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
            for f in anon_u8:
                writer.write(f)
            for i in range(start, start + count):
                if i in grid_idx:
                    grid_orig[i] = frames[i - start]
                    grid_anon[i] = anon_u8[i - start]
    finally:
        vr.close()
        writer.close()

    idx = sorted(grid_orig)
    top = np.concatenate([grid_orig[i] for i in idx], axis=1)
    bottom = np.concatenate([grid_anon[i] for i in idx], axis=1)
    png_path = write_png(os.path.join(out_dir, f"{base}_grid.png"), np.concatenate([top, bottom], axis=0))
    return {"video": video_path, "grid": png_path}
