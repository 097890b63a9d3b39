"""Validation crops as plain PyTorch (counterpart of ``center_crop_resize``,
``multi_crop_resize`` and ``five_crop_corners`` in ted_spad_tpu/ops/augment.py): crop,
antialiased bilinear resize (``F.interpolate``), optional mirror. Independent of the
resample matrices of ops/preprocess.py, so tests hold both against each other; the
windows come from ops/preprocess.py (``center_crop``, ``multi_crops``)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ted_spad_tpu_torch.ops.preprocess import Crop, center_crop, multi_crops


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
