"""2D ResNet backbone with BasicBlocks: the UNet++ anonymizer's ResNet-18 encoder
(counterpart of ted_spad_tpu/models/resnet2d.py). Layout NCHW."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ted_spad_tpu_torch.models.layers import ConvBN


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3 -> 3x3, expansion 1."""

    def __init__(self, inplanes: int, planes: int, stride: int, downsample: bool, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv1 = ConvBN(inplanes, planes, (3, 3), stride, 1, generator=generator)
        self.conv2 = ConvBN(planes, planes, (3, 3), 1, 1, act=False, generator=generator)
        self.downsample = (
            ConvBN(inplanes, planes, (1, 1), stride, 0, act=False, generator=generator)
            if downsample else None
        )

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x, train)
        out = self.conv2(self.conv1(x, train), train)
        return F.relu(out + residual, inplace=True)


class ResNet2D(nn.Module):
    """torchvision-style ResNet returning per-stage feature maps
    [input, stem(/2), layer1(/4), layer2(/8), layer3(/16), layer4(/32)][: depth+1].

    Only ``block="basic"`` is ported; the bottleneck variant (fb ResNet-50) comes
    with privacy training."""

    def __init__(
        self,
        block: str = "basic",
        layers: Sequence[int] = (2, 2, 2, 2),
        depth: int = 4,
        width: int = 64,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        if block != "basic":
            raise NotImplementedError(f"ResNet2D block={block!r}: only 'basic' is ported")
        self.depth = depth
        self.stem = ConvBN(3, width, (7, 7), 2, 3, generator=generator)
        inplanes = width
        self.stage_names: list[list[str]] = []
        for stage, n_blocks in enumerate(layers):
            if stage + 2 > depth:
                break
            planes = width * (1, 2, 4, 8)[stage]
            stride = 1 if stage == 0 else 2
            names = []
            for i in range(n_blocks):
                s = stride if i == 0 else 1
                down = i == 0 and (s != 1 or inplanes != planes)
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, BasicBlock(inplanes, planes, s, down, generator=generator))
                names.append(name)
                inplanes = planes
            self.stage_names.append(names)
        self.channels = [3, width] + [width * (1, 2, 4, 8)[i] for i in range(len(self.stage_names))]

    def forward(self, x: torch.Tensor, train: bool = False) -> list[torch.Tensor]:
        """Per-stage feature maps; ``train`` uses and updates BN's batch statistics."""
        feats = [x]
        x = self.stem(x, train)
        feats.append(x)
        if self.depth < 2:
            return feats
        # torchvision maxpool k3 s2 pad=1: symmetric -inf padding, NOT TF-SAME.
        x = F.max_pool2d(x, 3, 2, padding=1)
        for names in self.stage_names:
            for name in names:
                x = getattr(self, name)(x, train)
            feats.append(x)
        return feats
