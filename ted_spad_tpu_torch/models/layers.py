"""Shared building blocks of the port's model zoo (counterpart of
ted_spad_tpu/models/layers.py).

Modules work in PyTorch's NCHW / NCDHW layouts; the spatial helpers below take
those layouts. Initialization draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# Torch BatchNorm defaults (the reference's): eps 1e-5.
BN_EPS = 1e-5


def kaiming_normal_fan_out_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """``nn.init.kaiming_normal_(mode='fan_out')`` drawn from ``generator``."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


class ConvBN(nn.Module):
    """conv -> BN -> optional ReLU, 2D or 3D by the rank of ``kernel_size``, BN in
    eval mode (running statistics). Parameter names follow the flax module:
    ``conv.weight[/bias]``, ``bn.weight/bias/running_mean/running_var``."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: Sequence[int],
        stride: int | Sequence[int] = 1,
        padding: int | Sequence[int] = 0,
        *,
        use_bias: bool = False,
        act: bool = True,
        generator: torch.Generator,
    ):
        super().__init__()
        conv_cls = {2: nn.Conv2d, 3: nn.Conv3d}[len(kernel_size)]
        bn_cls = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[len(kernel_size)]
        self.conv = conv_cls(in_ch, out_ch, tuple(kernel_size), stride, padding, bias=use_bias)
        self.bn = bn_cls(out_ch, eps=BN_EPS)
        self.act = act
        kaiming_normal_fan_out_(self.conv.weight, generator)
        if use_bias:
            nn.init.zeros_(self.conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x, inplace=True) if self.act else x


def resize_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbor upsample of (H, W) by an integer scale (smp UnetPlusPlus
    DecoderBlock interpolate mode); keeps the memory format."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def resize_bilinear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Bilinear upsample of (H, W) by an integer scale, align_corners=True
    (unet_parts.py:53), computed in float32 and cast back as the JAX package does;
    keeps the memory format."""
    h, w = x.shape[-2], x.shape[-1]
    out = F.interpolate(x.float(), size=(h * scale, w * scale), mode="bilinear",
                        align_corners=True)
    return out.to(x.dtype)


def pad_to_match(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Zero-pad (H, W) centered, torch ``F.pad([dx//2, dx-dx//2, ...])``
    (unet_parts.py:56-63)."""
    dh = target_h - x.shape[-2]
    dw = target_w - x.shape[-1]
    if dh == 0 and dw == 0:
        return x
    return F.pad(x, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])


def max_pool_valid(x: torch.Tensor, window: Sequence[int], strides: Sequence[int]) -> torch.Tensor:
    """torch MaxPool with padding=0 (floor mode) == VALID pooling, 2D or 3D."""
    pool = {2: F.max_pool2d, 3: F.max_pool3d}[len(window)]
    return pool(x, tuple(window), tuple(strides))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over all spatial dims in float32: (B, C, ...) -> (B, C)."""
    return x.float().mean(dim=tuple(range(2, x.dim())))


def tf_same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF's dynamic SAME padding of one dim (i3d.py:15-19, 89-111): ``pad // 2`` in
    front, the rest behind."""
    pad = max(kernel - (stride if size % stride == 0 else size % stride), 0)
    return pad // 2, pad - pad // 2


def pad_tf_same(x: torch.Tensor, window: Sequence[int], strides: Sequence[int],
                value: float = 0.0) -> torch.Tensor:
    """``x`` (B, C, *spatial) padded as TF's dynamic SAME padding asks for ``window``
    and ``strides`` over the spatial dims (asymmetric where the pad is odd)."""
    pads = [tf_same_pads(x.shape[2 + d], k, s) for d, (k, s) in enumerate(zip(window, strides))]
    if not any(lo or hi for lo, hi in pads):
        return x
    return F.pad(x, [p for pair in reversed(pads) for p in pair], value=value)


def max_pool_same(x: torch.Tensor, window: Sequence[int], strides: Sequence[int]) -> torch.Tensor:
    """MaxPool3dSamePadding (i3d.py:13-45): TF-SAME padding with the dtype's lowest
    finite value, then a VALID max pool over the spatial dims of (B, C, *spatial)."""
    x = pad_tf_same(x, window, strides, value=torch.finfo(x.dtype).min)
    return max_pool_valid(x, window, strides)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator, std: float | None = None) -> None:
    """Normal weights of std 1/sqrt(fan_in) (flax's default kernel init), or ``std``,
    drawn from ``generator``."""
    fan_in = math.prod(weight.shape[1:])
    with torch.no_grad():
        weight.normal_(0.0, std if std is not None else 1.0 / math.sqrt(fan_in), generator=generator)
