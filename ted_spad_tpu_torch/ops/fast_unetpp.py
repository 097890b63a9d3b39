"""The pieces of the UNet++ eval fast path that the int8 serving mode runs
(counterpart of part of ted_spad_tpu/ops/fast_unetpp.py): the schedule of the nested-skip
decoder with its Cout-batched skip convolutions and its ``block`` / ``conv`` plug points,
the up2 convolution as a lhs-dilated 4x4 one, the plain stride-2 encoder stem, the
ResNet max pool, folded eval BatchNorm and the segmentation head.

Pure functions over the unchanged ``models.unet.UNetPlusPlus`` module, in NHWC
(activations) and HWIO (kernels, float32, read from the module's weights); the JAX
package's space-to-depth stem and head are not ported (TPU lane tricks).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Fine-tap -> 4-tap mixing of the lhs-dilated up2 form: W4[j] = sum over t in {0, 1} of
# W3[2 - j + t] (valid indices), i.e. the 3x3 kernel correlated with a 2x2 box
# (nearest_up2 is zero-stuffing then a 2x2 box), flipped for correlation.
_D = np.zeros((4, 3), np.float32)
for _j in range(4):
    for _t in (0, 1):
        if 0 <= 2 - _j + _t <= 2:
            _D[_j, 2 - _j + _t] = 1.0
_DF = _D[::-1].copy()

# (layer name, num blocks, first-block stride) of the depth-4 ResNet-18 encoder.
_R18_ENC_LAYERS = (("layer1", 2, 1), ("layer2", 2, 2), ("layer3", 2, 2))


def up2_dilated_kernel(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (4, 4, Cin, Cout) kernel K with
    ``conv(x, K, lhs_dilation=2, padding=2) == conv3x3_SAME(nearest_up2(x))``."""
    d = torch.from_numpy(_DF).to(w.device, w.dtype)
    return torch.einsum("ae,bf,efio->abio", d, d, w)


def kernel(conv: torch.nn.Module) -> torch.Tensor:
    """A conv module's weight as a float32 HWIO / DHWIO kernel."""
    w = conv.weight.float()
    return w.permute(*range(2, w.dim()), 1, 0)


def _torch_pads(padding) -> tuple[list[int], tuple[int, ...] | None]:
    """(F.pad list, symmetric padding tuple or None) of explicit (low, high) pads."""
    pads = [tuple(p) for p in padding]
    if all(lo == hi for lo, hi in pads):
        return [], tuple(lo for lo, _ in pads)
    return [p for pair in reversed(pads) for p in pair], None


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, strides, padding, dtype: torch.dtype) -> torch.Tensor:
    """A convolution in ``dtype`` on NHWC / NDHWC ``x`` with an HWIO / DHWIO kernel,
    explicit (low, high) pads: XLA's ``conv_general_dilated(x.astype(dtype),
    w.astype(dtype), strides, padding, preferred_element_type=dtype)``."""
    nd = w.dim() - 2
    xt = x.to(dtype).movedim(-1, 1)  # NCHW view: channels_last memory for an NHWC x
    fmt = torch.channels_last if nd == 2 else torch.channels_last_3d
    wt = w.to(dtype).permute(nd + 1, nd, *range(nd)).contiguous(memory_format=fmt)
    pad_list, sym = _torch_pads(padding)
    conv = F.conv2d if nd == 2 else F.conv3d
    y = conv(F.pad(xt, pad_list), wt, stride=tuple(strides)) if sym is None else \
        conv(xt, wt, stride=tuple(strides), padding=sym)
    return y.movedim(1, -1)


def up2_conv(x: torch.Tensor, w44: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv(x, w44, lhs_dilation=(2, 2), padding=((2, 2), (2, 2)))`` in ``dtype`` on
    NHWC ``x``: a transposed convolution (stride 2, padding 1) with the spatially
    flipped kernel, so the zero-stuffed input is never built."""
    wt = w44.flip(0, 1).permute(2, 3, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)
    y = F.conv_transpose2d(x.to(dtype).movedim(-1, 1), wt, stride=2, padding=1)
    return y.movedim(1, -1)


def _stem_conv(stem, frames: torch.Tensor, dtype: torch.dtype,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """The stride-2 7x7 encoder stem, the plain form (the JAX package's "plain" mode).
    ``weight``: the stem's kernel already in ``dtype``, if the caller keeps one."""
    w = weight if weight is not None else kernel(stem.conv)
    return conv_nhwc(frames, w, (2, 2), ((3, 3), (3, 3)), dtype)


def _resnet_maxpool(x: torch.Tensor) -> torch.Tensor:
    """torchvision's max pool k3 s2 with symmetric pad 1 on NHWC (-inf padding)."""
    return F.max_pool2d(x.movedim(-1, 1), 3, 2, padding=1).movedim(1, -1)


def encoder_layout_standard(encoder: torch.nn.Module) -> bool:
    """True iff the encoder is the reference ResNet-18 depth-4 layout the inline
    encoder is derived for: a (7, 7, 3, 64) stem, layer1..layer3 of two blocks, no
    layer4."""
    stem = getattr(getattr(encoder, "stem", None), "conv", None)
    return (
        stem is not None
        and tuple(stem.weight.shape) == (64, 3, 7, 7)
        and all(hasattr(encoder, f"{ln}_{i}") for ln, nb, _ in _R18_ENC_LAYERS for i in range(nb))
        and not hasattr(encoder, "layer4_0")
    )


def _bn_affine(bn: torch.nn.Module, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm folded to (scale, bias), in float32."""
    scale = bn.weight.float() / torch.sqrt(bn.running_var.float() + eps)
    return scale, bn.bias.float() - bn.running_mean.float() * scale


def _pad_to(y: torch.Tensor, target_shape) -> torch.Tensor:
    """Centre-pad NHWC y's spatial dims to the target's (models/layers.pad_to_match)."""
    if tuple(y.shape[-3:-1]) == tuple(target_shape[-3:-1]):
        return y
    dh = target_shape[-3] - y.shape[-3]
    dw = target_shape[-2] - y.shape[-2]
    return F.pad(y, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


def _decoder_schedule(model, f: list, dtype: torch.dtype, block, conv=None):
    """The UNet++ nested-skip decoder with its multi-consumer skip convs batched along
    Cout: f[2] feeds x_1_1 + x_0_1, f[3] feeds x_2_2 + x_1_2 + x_0_2, and x_2_2 feeds
    x_1_2 + x_0_2. Channel slices follow the module's concat layout (conv1 input =
    [up(x), *skips]).

    ``block(name, xin, skip_sum)`` runs one decoder block given its precomputed conv1
    skip contribution. ``conv(site, x, w)`` runs one skip conv (default: the plain conv
    in ``dtype``); ``w`` is a zero-argument callable giving the float32 HWIO kernel, so
    an executor that keeps its own (quantized) copy computes it only once. Skip conv
    outputs are plain ``dtype`` tensors. Returns x_0_3 (full resolution, pre-head)."""
    if conv is None:
        def conv(site, x, w):
            return conv_nhwc(x, w(), (1, 1), ((1, 1), (1, 1)), dtype)

    def w1(name):
        return kernel(getattr(model, name).conv1.conv)

    x_0_0 = block("x_0_0", f[0], conv("sk_f1", f[1], lambda: w1("x_0_0")[:, :, 256:384, :]))
    f2c = conv("sk_f2", f[2], lambda: torch.cat(
        [w1("x_1_1")[:, :, 128:192, :], w1("x_0_1")[:, :, 320:384, :]], dim=-1))  # 64 + 128
    f3c = conv("sk_f3", f[3], lambda: torch.cat(
        [w1("x_2_2")[:, :, 64:128, :], w1("x_1_2")[:, :, 128:192, :],
         w1("x_0_2")[:, :, 256:320, :]], dim=-1))  # 64 * 3
    x_1_1 = block("x_1_1", f[1], f2c[..., :64])
    x_2_2 = block("x_2_2", f[2], f3c[..., :64])
    x22c = conv("sk_x22", x_2_2, lambda: torch.cat(
        [w1("x_1_2")[:, :, 64:128, :], w1("x_0_2")[:, :, 192:256, :]], dim=-1))  # 64 + 64
    x_0_1 = block("x_0_1", x_0_0,
                  conv("sk_x11", x_1_1, lambda: w1("x_0_1")[:, :, 256:320, :]) + f2c[..., 64:192])
    x_1_2 = block("x_1_2", x_1_1, x22c[..., :64] + f3c[..., 64:128])
    x_0_2 = block("x_0_2", x_0_1,
                  conv("sk_x12", x_1_2, lambda: w1("x_0_2")[:, :, 128:192, :])
                  + x22c[..., 64:128] + f3c[..., 128:192])
    return block("x_0_3", x_0_2, None)


def _apply_head(head: torch.nn.Module, x_0_3: torch.Tensor, in_h: int, in_w: int,
                dtype: torch.dtype, weight: torch.Tensor | None = None) -> torch.Tensor:
    """Pad x_0_3 back to the input resolution and apply the segmentation head's 3x3
    conv in ``dtype``, its bias added after, as a float32 (N, H, W, Cout) output (the JAX
    package's ``emit_s2d=False`` form). ``weight``: the head's kernel already in
    ``dtype``, if the caller keeps one."""
    if tuple(x_0_3.shape[-3:-1]) != (in_h, in_w):
        x_0_3 = _pad_to(x_0_3, (in_h, in_w, 0))
    w = weight if weight is not None else kernel(head)
    out = conv_nhwc(x_0_3, w, (1, 1), ((1, 1), (1, 1)), dtype) + head.bias.to(dtype)
    return out.float()
