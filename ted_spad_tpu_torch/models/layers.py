"""Shared building blocks of the port's model zoo (counterpart of
ted_spad_tpu/models/layers.py).

Modules work in PyTorch's NCHW / NCDHW layouts; the spatial helpers below take
those layouts. Initialization draws from an explicit ``torch.Generator``.

Train mode follows flax, not torch: ``flax_batch_norm`` normalises with the biased
batch variance and moves the running statistics as ``ra = 0.9 ra + 0.1 stat``
(torch's train-mode BatchNorm stores the unbiased variance, with momentum meaning the
reverse, so it is never used), and ``dropout`` draws from an explicit generator.

Under data parallel (inside ``parallel.active(mesh)``) both see the global batch:
``flax_batch_norm`` all-reduces its sums, so the statistics are those of every rank's
rows, and a dropout mask is drawn for the global batch and each rank keeps its rows,
so a sharded step draws the one-process step's masks.

``checkpoint`` is activation checkpointing (JAX's ``jax.checkpoint``, the adversarial
stage's ``remat``) that keeps both of these exact: the running statistics move once
per forward the step asks for, not again while the backward recomputes, and a
recompute replays the dropout masks its first run drew.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ted_spad_tpu_torch.parallel.mesh import active_mesh
from ted_spad_tpu_torch.utils.device import at_least_f32

# Torch BatchNorm defaults (the reference's): eps 1e-5, momentum 0.1 (flax's 0.9).
BN_EPS = 1e-5
BN_MOMENTUM = 0.9

# Set on the thread that recomputes a checkpointed forward during the backward.
_recompute = threading.local()


def recomputing() -> bool:
    """Whether the current thread is recomputing a ``checkpoint``ed forward."""
    return getattr(_recompute, "active", False)


def checkpoint(fn: Callable, *args, generators: Sequence[torch.Generator] = ()):
    """``fn(*args)`` under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:
    only the inputs are kept, and the backward runs ``fn`` again for its
    intermediates. Two traps of a train-mode forward are closed:

    - BN statistics: ``flax_batch_norm`` moves the running statistics in place; while
      recomputing it does not (``recomputing()``), so they move once, as under
      ``jax.checkpoint``, which is functional;
    - dropout: ``torch.utils.checkpoint`` restores only torch's default RNG states,
      not an explicit generator's. The states of ``generators`` (those ``fn`` draws
      from) are taken before the first run and set again for the recompute, which so
      draws the same masks; afterwards each generator is put back where it was.

    Without grad mode this is ``fn(*args)``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    generators = tuple(generators)
    first = [g.get_state() for g in generators]
    runs = []

    def run(*inputs):
        if not runs:
            runs.append(1)
            return fn(*inputs)
        now = [g.get_state() for g in generators]
        for g, state in zip(generators, first):
            g.set_state(state)
        outer, _recompute.active = recomputing(), True
        try:
            return fn(*inputs)
        finally:
            _recompute.active = outer
            for g, state in zip(generators, now):
                g.set_state(state)

    # Every draw goes through an explicit generator: torch's own RNG states need no copy.
    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def flax_batch_norm(bn: nn.modules.batchnorm._NormBase, x: torch.Tensor,
                    momentum: float = BN_MOMENTUM) -> torch.Tensor:
    """flax ``nn.BatchNorm(use_running_average=False)`` on (B, C, ...): normalise with
    the batch mean and the biased batch variance over every axis but the channels',
    taken as E[x^2] - E[x]^2 in float32 (flax's fast variance; float64 stays float64),
    and move ``bn``'s running statistics as ``ra = momentum * ra + (1 - momentum) *
    stat`` with that biased variance (not while a ``checkpoint``ed forward is
    recomputed). Gradients flow through the batch statistics; the output is in
    ``x``'s dtype. Inside ``parallel.active(mesh)`` the statistics are the global
    batch's: (sum x, sum x^2) all-reduced over the ranks, differentiably, as GSPMD
    reduces a sharded batch axis."""
    xf = at_least_f32(x)
    dims = [0] + list(range(2, x.dim()))
    act = active_mesh()
    if act is None:
        mean = xf.mean(dim=dims)
        var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
    else:
        mesh = act[0]
        count = (x.numel() // x.shape[1]) * mesh.world_size  # every rank holds as many rows
        sums = mesh.all_reduce(torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)]))
        mean = sums[0] / count
        var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
    if not recomputing():
        with torch.no_grad():
            bn.running_mean.copy_(momentum * bn.running_mean + (1.0 - momentum) * mean)
            bn.running_var.copy_(momentum * bn.running_var + (1.0 - momentum) * var)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((xf - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)).to(x.dtype)


def batch_norm(bn: nn.modules.batchnorm._NormBase, x: torch.Tensor, train: bool = False,
               frozen: bool = False, momentum: float = BN_MOMENTUM) -> torch.Tensor:
    """``bn`` in flax's semantics: batch statistics (updating the running ones with
    flax's ``momentum``) with ``train``, else the running statistics, never updated;
    ``frozen`` (the reference's FrozenBN, large_i3d.py:8-39) keeps the running
    statistics in train mode too while the affine parameters still train."""
    if train and not frozen:
        return flax_batch_norm(bn, x, momentum)
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                        bn.eps)


def magnitude_dropout(shape, rate: float, generator: torch.Generator | None,
                      device: torch.device) -> torch.Tensor | None:
    """flax ``Dropout(rate)`` applied to ones (MGFN's magnitude dropout, mgfn.py:217-219):
    each entry is kept with probability 1 - rate and then reads 1 / (1 - rate), else 0.
    The mask comes from ``generator`` (on ``device``), never from torch's global RNG.
    None at rate 0, where flax's Dropout is the identity. Inside
    ``parallel.active(mesh)`` the leading axis is this rank's rows: the mask is drawn
    for the global batch and the rank keeps its rows of it."""
    if rate == 0.0:
        return None
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit torch.Generator")
    keep = 1.0 - rate
    act = active_mesh()
    if act is None:
        draw = torch.rand(shape, generator=generator, device=generator.device)
    else:
        mesh, parts = act
        shape = (shape[0] * mesh.world_size,) + tuple(shape[1:])
        draw = mesh.take_rows(torch.rand(shape, generator=generator, device=generator.device),
                              parts=parts)
    draw = draw.to(device)
    return torch.where(draw < keep, torch.full_like(draw, 1.0 / keep), torch.zeros_like(draw))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in train mode: ``x`` times ``magnitude_dropout``'s mask
    (kept entries scaled by 1 / (1 - rate)); the identity at rate 0."""
    mask = magnitude_dropout(x.shape, rate, generator, x.device)
    return x if mask is None else x * mask.to(x.dtype)


def kaiming_normal_fan_out_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """``nn.init.kaiming_normal_(mode='fan_out')`` drawn from ``generator``."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


class ConvBN(nn.Module):
    """conv -> BN -> optional ReLU, 2D or 3D by the rank of ``kernel_size``; BN in
    flax's semantics (``batch_norm``): running statistics unless ``train``, and with
    ``frozen_bn`` in train mode too. Parameter names follow the flax module:
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

    def forward(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False) -> torch.Tensor:
        x = batch_norm(self.bn, self.conv(x), train, frozen_bn)
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
    """Mean over all spatial dims in float32 (float64 stays float64): (B, C, ...) -> (B, C)."""
    return at_least_f32(x).mean(dim=tuple(range(2, x.dim())))


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
