"""Clip augmentation (counterpart of ted_spad_tpu/ops/augment.py).

Training augmentation (ucf101_dl.py:95-195, vispr_dl.py:72-123): the random draw is
numpy on the host (``sample_augment_params`` -> ``AugmentParams``, the same
distributions and the same draw order as the JAX package, so one seed gives the same
parameters in both); the pixel work runs batched on the clips' device
(``augment_batch``): the crop and antialiased resize as two per-clip resample
matrices (``scale_translate_matrix``, a numpy copy of ``jax.image.scale_and_translate``'s
weights) applied with batched products, then the colour ops, the mirror and two
erase boxes as elementwise tensor work. Like the JAX package, the one-pass resample
reads up to a pixel past the crop box into the frame (torchvision crops first), and
the colour ops run on float32 in [0, 1].

Validation crops as plain PyTorch (``center_crop_resize``, ``multi_crop_resize``,
``five_crop_corners``): crop, antialiased bilinear resize (``F.interpolate``), optional
mirror. Independent of the resample matrices of ops/preprocess.py, so tests hold both
against each other; the windows come from ops/preprocess.py (``center_crop``,
``multi_crops``)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ted_spad_tpu_torch.ops.preprocess import Crop, center_crop, multi_crops


@dataclasses.dataclass
class AugmentParams:
    """Per-clip augmentation parameters, numpy arrays of leading size N (clips, or
    frames in the frame-wise mode); the fields and distributions of ucf101_dl.py:95-122."""

    # Crop box in source pixels.
    y0: np.ndarray
    x0: np.ndarray
    crop_h: np.ndarray
    crop_w: np.ndarray
    # Colour gates (bool) and factors.
    do_contrast: np.ndarray
    contrast: np.ndarray
    do_hue: np.ndarray
    hue: np.ndarray
    do_saturation: np.ndarray
    saturation: np.ndarray
    do_brightness: np.ndarray
    brightness: np.ndarray
    do_grayscale: np.ndarray
    do_gamma: np.ndarray
    gamma: np.ndarray
    do_hflip: np.ndarray
    # Two erase boxes in output pixels, (N, 2) each.
    do_erase: np.ndarray
    erase_y: np.ndarray
    erase_x: np.ndarray
    erase_h: np.ndarray
    erase_w: np.ndarray


def sample_augment_params(
    rng: np.random.Generator,
    batch: int,
    src_h: int,
    src_w: int,
    out_h: int = 224,
    out_w: int = 224,
    min_crop: float = 0.6,
    no_ar_distortion: bool = False,
    aspect_ratio_aug: bool = False,
    weak: bool = False,
) -> AugmentParams:
    """The reference's per-clip draw (ucf101_dl.py:95-122), in the JAX package's draw
    order. ``weak``: crop and resize only (weak_augmentation, :185-195).
    ``aspect_ratio_aug`` widens only the y0 sampling range (the box may hang past the
    bottom edge, where the resample reads zeros)."""
    min_size = min(src_h, src_w)
    cf = rng.uniform(min_crop, 1.0, size=(batch, 2))
    if no_ar_distortion:
        crop_h = (min_size * cf[:, 0]).astype(np.int32)
        crop_w = crop_h.copy()
    else:
        crop_h = (src_h * cf[:, 0]).astype(np.int32)
        crop_w = (src_w * cf[:, 0]).astype(np.int32)
    x0 = (rng.random(batch) * (src_w - crop_w + 1)).astype(np.int32)
    y_range = (src_h * cf[:, 1]).astype(np.int32) if aspect_ratio_aug and not no_ar_distortion \
        else crop_h
    y0 = (rng.random(batch) * np.maximum(src_h - y_range + 1, 1)).astype(np.int32)
    r = rng.random((batch, 10))
    off = np.zeros(batch, bool)
    return AugmentParams(
        y0=y0, x0=x0, crop_h=crop_h, crop_w=crop_w,
        # contrast fires in two disjoint windows totalling p = 0.125 (ucf101_dl.py:160-168).
        do_contrast=off if weak else (r[:, 0] < 0.125),
        contrast=rng.uniform(0.9, 1.1, batch),
        do_hue=off if weak else (r[:, 1] < 0.15),
        hue=rng.uniform(-0.05, 0.05, batch),
        do_saturation=off if weak else (r[:, 2] < 0.15),
        saturation=rng.uniform(0.9, 1.1, batch),
        do_brightness=off if weak else (r[:, 3] < 0.15),
        brightness=rng.uniform(0.9, 1.1, batch),
        do_grayscale=off if weak else (r[:, 4] > 0.9),
        do_gamma=off if weak else ((r[:, 4] > 0.9) & (r[:, 5] > 0.25)),
        gamma=rng.uniform(0.85, 1.15, batch),
        do_hflip=off if weak else (r[:, 6] > 0.5),
        do_erase=np.zeros((batch, 2), bool) if weak else (r[:, 7:9] < 0.4),
        erase_y=rng.integers(0, out_w, size=(batch, 2)).astype(np.int32),  # the reference's x as row
        erase_x=rng.integers(0, out_h, size=(batch, 2)).astype(np.int32),
        erase_h=rng.integers(max(int((src_h / 6) * (out_h / 224)), 1),
                             max(int((src_h / 3) * (out_h / 224)), 2), size=(batch, 2)).astype(np.int32),
        erase_w=rng.integers(max(int((src_w / 6) * (out_h / 224)), 1),
                             max(int((src_w / 3) * (out_h / 224)), 2), size=(batch, 2)).astype(np.int32),
    )


def expand_framewise(params: AugmentParams, num_frames: int, rng: np.random.Generator,
                     erase_size: int = 19) -> AugmentParams:
    """Per-clip draw -> per-frame draw (ucf101_dl.py:125-135): the gates, the crop box
    and the erase positions repeat over a clip's frames; the colour factors and the
    erase sizes (U[erase_size/2, erase_size)) are drawn anew per frame."""
    out = AugmentParams(**{f.name: np.repeat(getattr(params, f.name), num_frames, axis=0)
                           for f in dataclasses.fields(params)})
    n = params.y0.shape[0] * num_frames
    out.contrast = rng.uniform(0.9, 1.1, n)
    out.hue = rng.uniform(-0.05, 0.05, n)
    out.saturation = rng.uniform(0.9, 1.1, n)
    out.brightness = rng.uniform(0.9, 1.1, n)
    out.gamma = rng.uniform(0.85, 1.15, n)
    out.erase_h = rng.integers(erase_size // 2, erase_size, size=(n, 2)).astype(np.int32)
    out.erase_w = rng.integers(erase_size // 2, erase_size, size=(n, 2)).astype(np.int32)
    return out


def scale_translate_matrix(in_size: int, out_size: int, start: np.ndarray,
                           length: np.ndarray) -> np.ndarray:
    """(N, out_size, in_size) float32 resample matrices mapping the source window
    [start, start + length) onto ``out_size`` output pixels: the weights of
    ``jax.image.scale_and_translate(method="linear", antialias=True)`` at scale
    ``out_size / length`` and translation ``-start * scale``, in its float32
    arithmetic (jax/_src/image/scale.py, ``compute_weight_mat``). A triangle kernel
    widened by 1/scale when downscaling; taps outside the input are dropped and the
    rest renormalised (so the taps may extend past the window into the frame); output
    pixels whose sample falls outside the input read zero."""
    f32 = np.float32
    scale = f32(out_size) / np.asarray(length, f32)[:, None, None]
    translation = -np.asarray(start, f32)[:, None, None] * scale
    inv_scale = f32(1.0) / scale
    kernel_scale = np.maximum(inv_scale, f32(1.0))
    sample = ((np.arange(out_size, dtype=f32)[None, :, None] + f32(0.5)) * inv_scale
              - translation * inv_scale - f32(0.5))  # (N, out, 1)
    x = np.abs(sample - np.arange(in_size, dtype=f32)[None, None, :]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=2, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside, w, f32(0.0)).astype(f32)


def _matrices(in_size: int, out_size: int, start, length, device) -> torch.Tensor:
    """(N, out, in) matrices on ``device``, each distinct (start, length) computed once."""
    keys = np.stack([np.asarray(start), np.asarray(length)], axis=1)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    mats = torch.from_numpy(scale_translate_matrix(in_size, out_size, uniq[:, 0], uniq[:, 1]))
    return mats.to(device)[torch.from_numpy(inverse.reshape(-1)).to(device)]


def crop_resize(frames: torch.Tensor, y0, x0, crop_h, crop_w, out_h: int,
                out_w: int) -> torch.Tensor:
    """Antialiased crop and resize of N clips (N, T, H, W, C) float -> (N, T, out_h,
    out_w, C) with each clip's box (numpy arrays of length N): JAX's
    ``crop_resize_one`` per clip, as two batched products."""
    _, _, h, w, _ = frames.shape
    wy = _matrices(h, out_h, y0, crop_h, frames.device).to(frames.dtype)
    wx = _matrices(w, out_w, x0, crop_w, frames.device).to(frames.dtype)
    rows = torch.einsum("noh,nthwc->ntowc", wy, frames)
    return torch.einsum("npw,ntowc->ntopc", wx, rows)


_GRAY_W = (0.299, 0.587, 0.114)  # torchvision's rgb_to_grayscale


def _gray(img: torch.Tensor) -> torch.Tensor:
    return img @ torch.tensor(_GRAY_W, dtype=img.dtype, device=img.device)


def _blend(img: torch.Tensor, other: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return factor * img + (1.0 - factor) * other


def adjust_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Blend with each frame's mean grey level."""
    return _blend(img, _gray(img).mean(dim=(-2, -1), keepdim=True)[..., None], factor)


def adjust_saturation(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return _blend(img, _gray(img)[..., None], factor)


def adjust_brightness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return img * factor


def adjust_gamma(img: torch.Tensor, gamma: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    return gain * torch.pow(torch.clamp(img, 1e-8, 1.0), gamma)


def rgb_to_hsv(img: torch.Tensor):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-8), torch.zeros_like(maxc))
    dz = torch.clamp(delta, min=1e-8)
    rc, gc, bc = (maxc - r) / dz, (maxc - g) / dz, (maxc - b) / dz
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return h, s, maxc


def hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    sector = torch.clamp(torch.remainder(i.long(), 6), 0, 5)[..., None]

    def pick(*options):
        return torch.gather(torch.stack(options, dim=-1), -1, sector)[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)],
                       dim=-1)


def adjust_hue(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    h, s, v = rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    return hsv_to_rgb(torch.remainder(h + shift[..., 0], 1.0), s, v)


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    return _gray(img)[..., None].expand(img.shape)


def erase_box(img: torch.Tensor, y, x, h, w) -> torch.Tensor:
    """Zero a box per clip (torchvision ``erase`` with v=0), clipped at the frame
    edges like slicing: img (N, T, H, W, C), box coordinates (N,) tensors."""
    hh = torch.arange(img.shape[-3], device=img.device)[None, :, None]
    ww = torch.arange(img.shape[-2], device=img.device)[None, None, :]
    y, x, h, w = (v[:, None, None] for v in (y, x, h, w))
    inside = (hh >= y) & (hh < y + h) & (ww >= x) & (ww < x + w)  # (N, H, W)
    return img.masked_fill(inside[:, None, :, :, None], 0.0)


def augment_batch(frames: torch.Tensor, params: AugmentParams, out_h: int = 224,
                  out_w: int = 224, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, T, H, W, C) uint8 (or float in [0, 255]) clips on their device + the host
    draw -> (B, T, out_h, out_w, C) in [0, 1], float32 (``dtype=torch.float64`` for a
    float64 reference step), in the order of
    ucf101_dl.py:149-182: crop and resize, contrast, hue, saturation, brightness,
    grayscale, gamma, mirror, clip to [0, 1], two erase boxes. Each colour op is
    computed for every clip and kept where its gate is set, as the JAX package does.
    Frame-wise mode (ucf101_dl.py:127-135): with B*T draws for T > 1, every frame is
    a clip of its own."""
    b, t = frames.shape[:2]
    n = params.y0.shape[0]
    if n == b * t and t != 1:
        out = augment_batch(frames.reshape((b * t, 1) + frames.shape[2:]), params, out_h, out_w, dtype)
        return out.reshape((b, t) + out.shape[2:])
    if n != b:
        raise ValueError(f"{n} draws for {b} clips of {t} frames")
    dev = frames.device

    def per_clip(name: str, as_type=dtype) -> torch.Tensor:
        a = torch.from_numpy(np.ascontiguousarray(getattr(params, name)))
        return a.to(dev, as_type).reshape((-1,) + (1,) * 4)

    img = crop_resize(frames.to(dtype) / 255.0, params.y0, params.x0, params.crop_h,
                      params.crop_w, out_h, out_w)
    for gate, fn, arg in (("do_contrast", adjust_contrast, "contrast"),
                          ("do_hue", adjust_hue, "hue"),
                          ("do_saturation", adjust_saturation, "saturation"),
                          ("do_brightness", adjust_brightness, "brightness"),
                          ("do_grayscale", lambda x, _: to_grayscale(x), None),
                          ("do_gamma", adjust_gamma, "gamma")):
        done = fn(img, per_clip(arg) if arg else None)
        img = torch.where(per_clip(gate, torch.bool), done, img)
    img = torch.where(per_clip("do_hflip", torch.bool), img.flip(-2), img)
    img = torch.clamp(img, 0.0, 1.0)
    box = {k: torch.from_numpy(np.ascontiguousarray(getattr(params, k))).to(dev)
           for k in ("do_erase", "erase_y", "erase_x", "erase_h", "erase_w")}
    for k in range(2):
        erased = erase_box(img, *(box[f][:, k] for f in ("erase_y", "erase_x", "erase_h", "erase_w")))
        img = torch.where(box["do_erase"][:, k].reshape(-1, 1, 1, 1, 1), erased, img)
    return img


def _unit_float(frames: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1]: uint8 input is scaled by 1/255, float input taken as it is."""
    img = frames.float()
    return img / 255.0 if frames.dtype == torch.uint8 else img


def _resize_crops(img: torch.Tensor, crops: Sequence[Crop], out_h: int, out_w: int) -> list:
    """Each crop of (..., T, H, W, C) float frames -> (..., T, out_h, out_w, C)."""
    *lead, _, _, c = img.shape
    views = []
    for crop in crops:
        v = img[..., crop.y0 : crop.y0 + crop.h, crop.x0 : crop.x0 + crop.w, :]
        v = v.reshape(-1, crop.h, crop.w, c).permute(0, 3, 1, 2)
        out = F.interpolate(v, size=(out_h, out_w), mode="bilinear", align_corners=False,
                            antialias=True)
        if crop.mirror:
            out = out.flip(-1)
        views.append(out.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c))
    return views


def center_crop_resize(frames: torch.Tensor, cropping_factor: float, out_h: int, out_w: int,
                       hflip: bool = False, no_ar_distortion: bool = False) -> torch.Tensor:
    """(..., T, H, W, C) -> (..., T, out_h, out_w, C) float32 (ucf101_dl.py:297-320;
    dali_extraction.py:38-50): the centre crop (a square of the shorter side with
    ``no_ar_distortion``), resized, mirrored with ``hflip``."""
    h, w = frames.shape[-3:-1]
    crop = center_crop(h, w, cropping_factor, square=no_ar_distortion)._replace(mirror=hflip)
    return _resize_crops(_unit_float(frames), [crop], out_h, out_w)[0]


def resize_frames(frames: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Whole (..., T, H, W, C) float frames resized to (..., T, out_h, out_w, C) with the
    antialiased bilinear filter (``jax.image.resize(method="linear")``)."""
    h, w = frames.shape[-3:-1]
    return _resize_crops(frames.float(), [Crop(0, 0, h, w)], out_h, out_w)[0]


def multi_crop_resize(frames: torch.Tensor, cropping_factor: float, out_h: int, out_w: int,
                      ncrops: int) -> torch.Tensor:
    """torchvision's five / ten crops (ops/preprocess.multi_crops' order), each resized:
    (..., T, H, W, C) -> (..., ncrops, T, out_h, out_w, C) float32, the crop axis before
    time, so per-clip features stack to the published MGFN (T, ncrops, F) layout."""
    h, w = frames.shape[-3:-1]
    views = _resize_crops(_unit_float(frames), multi_crops(h, w, cropping_factor, ncrops),
                          out_h, out_w)
    return torch.stack(views, dim=-5)


def five_crop_corners(frames: torch.Tensor, crop_h: int, crop_w: int):
    """The threeCrop views the reference adds (ucf101_dl.py:303-308): torchvision's
    five_crop [0] and [-2], top-left and bottom-right."""
    return frames[..., :crop_h, :crop_w, :], frames[..., -crop_h:, -crop_w:, :]
