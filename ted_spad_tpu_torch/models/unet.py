"""Anonymizer fa architectures (counterpart of ted_spad_tpu/models/unet.py):

- ``UNet``: the classic UNet (unet_model.py, bilinear variant), nine DoubleConv
  blocks, each one launch of kernel K2 on the card in eval mode; sigmoid RGB output.
  In train mode each DoubleConv runs its two ConvBNs unfolded (K2 folds eval-mode
  BN and has no backward).
- ``UNetPlusPlus``: smp's ``UnetPlusPlus(encoder_name='resnet18', encoder_depth=4,
  decoder_channels=(256,128,64,32), classes=3, activation=None)``; raw RGB output.

Per-frame 2D models on NCHW frames; output in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ted_spad_tpu_torch.models.layers import (
    ConvBN, checkpoint, max_pool_valid, pad_to_match, resize_bilinear, resize_nearest,
)
from ted_spad_tpu_torch.models.resnet2d import ResNet2D
from ted_spad_tpu_torch.ops.doubleconv import double_conv_reference, fold_bn, fused_double_conv


class DoubleConv(nn.Module):
    """(conv3x3 => BN => ReLU) * 2 (unet_parts.py:8-25), eval mode, as one fused
    DoubleConv: BN and the conv bias are folded into the weights in float32 on every
    call (so weights loaded later are always the ones used), the folded weights are
    rounded to the input's dtype, and ``fused_double_conv`` (K2 on the card) runs
    both convs. ``conv1`` / ``conv2`` hold the flax module's parameters."""

    def __init__(self, in_ch: int, features: int, mid_features: int | None = None, *,
                 generator: torch.Generator):
        super().__init__()
        mid = mid_features or features
        self.conv1 = ConvBN(in_ch, mid, (3, 3), 1, 1, use_bias=True, generator=generator)
        self.conv2 = ConvBN(mid, features, (3, 3), 1, 1, use_bias=True, generator=generator)

    @staticmethod
    def _folded(block: ConvBN, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """(w (3, 3, I, O) in ``dtype``, b float32) of one ConvBN."""
        conv, bn = block.conv, block.bn
        w, b = fold_bn(conv.weight.float().permute(2, 3, 1, 0), bn.weight.float(),
                       bn.bias.float(), bn.running_mean.float(), bn.running_var.float(),
                       bn.eps, bias=conv.bias.float())
        return w.to(dtype).contiguous(), b.contiguous()

    def forward(self, x: torch.Tensor, use_kernel: bool = True, train: bool = False) -> torch.Tensor:
        """(N, Cin, H, W) ``channels_last`` -> (N, Cout, H, W) ``channels_last``.
        ``use_kernel=False`` runs the plain version on any device. ``train`` runs the
        two ConvBNs unfolded, with BN's batch statistics, as the flax module does."""
        if train:
            return self.conv2(self.conv1(x, True), True)
        w1, b1 = self._folded(self.conv1, x.dtype)
        w2, b2 = self._folded(self.conv2, x.dtype)
        fn = fused_double_conv if use_kernel else double_conv_reference
        return fn(x.permute(0, 2, 3, 1), w1, b1, w2, b2).permute(0, 3, 1, 2)


class UNet(nn.Module):
    """Classic UNet fa (unet_model.py:6-37): bilinear variant, 64...512 channels,
    sigmoid RGB output. Decoder concatenations are [skip, up]."""

    def __init__(self, n_classes: int = 3, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.inc = DoubleConv(3, 64, generator=g)
        self.down1 = DoubleConv(64, 128, generator=g)
        self.down2 = DoubleConv(128, 256, generator=g)
        self.down3 = DoubleConv(256, 512, generator=g)
        self.down4 = DoubleConv(512, 512, generator=g)
        self.up1 = DoubleConv(1024, 256, 512, generator=g)
        self.up2 = DoubleConv(512, 128, 256, generator=g)
        self.up3 = DoubleConv(256, 64, 128, generator=g)
        self.up4 = DoubleConv(128, 64, 64, generator=g)
        self.outc = nn.Conv2d(64, n_classes, 1, bias=True)
        nn.init.normal_(self.outc.weight, 0.0, (1.0 / 64) ** 0.5, generator=g)
        nn.init.zeros_(self.outc.bias)

    def forward(self, x: torch.Tensor, use_kernel: bool = True, train: bool = False,
                remat_blocks: bool = False) -> torch.Tensor:
        """(N, 3, H, W) -> (N, n_classes, H, W) float32 in [0, 1]. ``use_kernel=False``
        runs every DoubleConv through its plain version; ``train`` runs them unfolded
        with BN's batch statistics; ``remat_blocks`` checkpoints each DoubleConv on its
        own (``layers.checkpoint``). In eval mode under autocast the DoubleConvs run
        in the autocast dtype (a float32 fa being trained, frozen for a step, runs
        them as the module's compute dtype would)."""
        cl = torch.channels_last
        dtype = self.outc.weight.dtype
        if not train and torch.is_autocast_enabled(x.device.type):
            dtype = torch.get_autocast_dtype(x.device.type)
        x = x.to(dtype).contiguous(memory_format=cl)

        def block(module: DoubleConv, t: torch.Tensor) -> torch.Tensor:
            if remat_blocks:
                return checkpoint(lambda u: module(u, use_kernel=use_kernel, train=train), t)
            return module(t, use_kernel=use_kernel, train=train)

        def down(module: DoubleConv, t: torch.Tensor) -> torch.Tensor:
            return block(module, max_pool_valid(t, (2, 2), (2, 2)).contiguous(memory_format=cl))

        def up(module: DoubleConv, t: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
            t = pad_to_match(resize_bilinear(t, 2), skip.shape[-2], skip.shape[-1])
            return block(module, torch.cat([skip, t], dim=1).contiguous(memory_format=cl))

        x1 = block(self.inc, x)
        x2 = down(self.down1, x1)
        x3 = down(self.down2, x2)
        x4 = down(self.down3, x3)
        x5 = down(self.down4, x4)
        y = up(self.up1, x5, x4)
        y = up(self.up2, y, x3)
        y = up(self.up3, y, x2)
        y = up(self.up4, y, x1)
        return torch.sigmoid(self.outc(y).float())


class UnetPPDecoderBlock(nn.Module):
    """smp DecoderBlock: nearest 2x upsample -> concat [up, skip] -> (conv3x3 BN ReLU) x2."""

    def __init__(self, in_ch: int, skip_ch: int, features: int, *, generator: torch.Generator):
        super().__init__()
        self.conv1 = ConvBN(in_ch + skip_ch, features, (3, 3), 1, 1, generator=generator)
        self.conv2 = ConvBN(features, features, (3, 3), 1, 1, generator=generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None, train: bool = False) -> torch.Tensor:
        x = resize_nearest(x, 2)
        if skip is not None:
            x = pad_to_match(x, skip.shape[-2], skip.shape[-1])
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x, train), train)


class UNetPlusPlus(nn.Module):
    """UNet++ with a ResNet-18 encoder of depth 4 and the dense nested skip grid of
    smp's UnetPlusPlusDecoder. ``decoder_channels`` / ``encoder_layers`` /
    ``encoder_width`` exist for the tiny test variant; the defaults are the
    reference architecture."""

    def __init__(
        self,
        out_channels: int = 3,
        decoder_channels: Sequence[int] = (256, 128, 64, 32),
        encoder_layers: Sequence[int] = (2, 2, 2, 2),
        encoder_width: int = 64,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        g = generator
        self.encoder = ResNet2D("basic", tuple(encoder_layers), depth=4, width=encoder_width,
                                generator=g)
        # Encoder feature channels, deepest first: f = [/16, /8, /4, /2].
        f = self.encoder.channels[1:][::-1]
        dec = tuple(decoder_channels)
        skip = (f[1], f[2], f[3])
        # Column 0 (the plain UNet diagonal).
        self.x_0_0 = UnetPPDecoderBlock(f[0], f[1], dec[0], generator=g)
        self.x_1_1 = UnetPPDecoderBlock(f[1], f[2], skip[1], generator=g)
        self.x_2_2 = UnetPPDecoderBlock(f[2], f[3], skip[2], generator=g)
        # Column 1: dense skips.
        self.x_0_1 = UnetPPDecoderBlock(dec[0], skip[1] + f[2], dec[1], generator=g)
        self.x_1_2 = UnetPPDecoderBlock(skip[1], skip[2] + f[3], skip[2], generator=g)
        # Column 2.
        self.x_0_2 = UnetPPDecoderBlock(dec[1], skip[2] + skip[2] + f[3], dec[2], generator=g)
        # Final no-skip upsample to full resolution.
        self.x_0_3 = UnetPPDecoderBlock(dec[2], 0, dec[3], generator=g)
        # Segmentation head: conv3x3, activation=None.
        self.head = nn.Conv2d(dec[3], out_channels, 3, padding=1, bias=True)
        nn.init.normal_(self.head.weight, 0.0, (1.0 / (dec[3] * 9)) ** 0.5, generator=g)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor, train: bool = False, remat_blocks: bool = False) -> torch.Tensor:
        """(N, 3, H, W) -> (N, out_channels, H, W) float32; ``train`` uses and updates
        BN's batch statistics. ``remat_blocks`` checkpoints each encoder stage and
        each decoder block on its own (``layers.checkpoint``): the block outputs stay
        resident, as under the JAX package's ``save_only_these_names`` policy over
        them, and only the insides are recomputed."""
        in_h, in_w = x.shape[-2], x.shape[-1]
        x = x.to(self.head.weight.dtype)
        f = self.encoder(x, train, remat_blocks)[1:][::-1]

        def dec(block: UnetPPDecoderBlock, t: torch.Tensor, skip: torch.Tensor | None) -> torch.Tensor:
            if remat_blocks:
                return checkpoint(lambda u, v: block(u, v, train), t, skip)
            return block(t, skip, train)

        x_0_0 = dec(self.x_0_0, f[0], f[1])  # /8
        x_1_1 = dec(self.x_1_1, f[1], f[2])  # /4
        x_2_2 = dec(self.x_2_2, f[2], f[3])  # /2
        x_0_1 = dec(self.x_0_1, x_0_0, torch.cat([x_1_1, f[2]], dim=1))  # /4
        x_1_2 = dec(self.x_1_2, x_1_1, torch.cat([x_2_2, f[3]], dim=1))  # /2
        x_0_2 = dec(self.x_0_2, x_0_1, torch.cat([x_1_2, x_2_2, f[3]], dim=1))  # /2
        x_0_3 = pad_to_match(dec(self.x_0_3, x_0_2, None), in_h, in_w)  # /1
        return self.head(x_0_3).float()
