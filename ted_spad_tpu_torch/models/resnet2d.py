"""2D ResNets (counterpart of ted_spad_tpu/models/resnet2d.py): the UNet++
anonymizer's ResNet-18 encoder (BasicBlocks) and the privacy model fb, a ResNet-50
(Bottlenecks) as a multi-label classifier (``ResNet50Classifier``,
build_resnet_predictor, model_loaders.py:157-168) or as the SimCLR model of the
adversarial stage (``ResNet50SSL``, load_privacy_ssl, model_loaders.py:124-149).
Layout NCHW. Train mode runs BN in flax's semantics (``layers.batch_norm``)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ted_spad_tpu_torch.models.layers import ConvBN, checkpoint, global_avg_pool, lecun_normal_
from ted_spad_tpu_torch.ops.losses import l2_normalize
from ted_spad_tpu_torch.utils.device import at_least_f32


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3 -> 3x3, expansion 1."""

    expansion = 1

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


class Bottleneck2D(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3 (stride) -> 1x1, expansion 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, downsample: bool, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.conv1 = ConvBN(inplanes, planes, (1, 1), 1, 0, generator=g)
        self.conv2 = ConvBN(planes, planes, (3, 3), stride, 1, generator=g)
        self.conv3 = ConvBN(planes, planes * 4, (1, 1), 1, 0, act=False, generator=g)
        self.downsample = (
            ConvBN(inplanes, planes * 4, (1, 1), stride, 0, act=False, generator=g)
            if downsample else None
        )

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x, train)
        out = self.conv3(self.conv2(self.conv1(x, train), train), train)
        return F.relu(out + residual, inplace=True)


class ResNet2D(nn.Module):
    """torchvision-style ResNet returning per-stage feature maps
    [input, stem(/2), layer1(/4), layer2(/8), layer3(/16), layer4(/32)][: depth+1].
    ``block``: 'basic' (ResNet-18/34) or 'bottleneck' (ResNet-50); ``width`` is the
    stem's, the stages' planes are width x (1, 2, 4, 8)."""

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
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"ResNet2D block={block!r}: 'basic' or 'bottleneck'")
        block_cls = BasicBlock if block == "basic" else Bottleneck2D
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
                down = i == 0 and (s != 1 or inplanes != planes * block_cls.expansion)
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, block_cls(inplanes, planes, s, down, generator=generator))
                names.append(name)
                inplanes = planes * block_cls.expansion
            self.stage_names.append(names)
        self.channels = [3, width] + [width * (1, 2, 4, 8)[i] * block_cls.expansion
                                      for i in range(len(self.stage_names))]

    def _stage(self, names: list[str], x: torch.Tensor, train: bool) -> torch.Tensor:
        for name in names:
            x = getattr(self, name)(x, train)
        return x

    def forward(self, x: torch.Tensor, train: bool = False,
                remat_blocks: bool = False) -> list[torch.Tensor]:
        """Per-stage feature maps; ``train`` uses and updates BN's batch statistics.
        ``remat_blocks`` checkpoints the stem and each stage on its own
        (``layers.checkpoint``): their outputs stay resident, their insides are
        recomputed in the backward."""
        run = checkpoint if remat_blocks else (lambda fn, *a: fn(*a))
        feats = [x]
        x = run(lambda t: self.stem(t, train), x)
        feats.append(x)
        if self.depth < 2:
            return feats
        # torchvision maxpool k3 s2 pad=1: symmetric -inf padding, NOT TF-SAME.
        x = F.max_pool2d(x, 3, 2, padding=1)
        for names in self.stage_names:
            x = run(lambda t, names=names: self._stage(names, t, train), x)
            feats.append(x)
        return feats


def _dense(in_f: int, out_f: int, generator: torch.Generator) -> nn.Linear:
    """flax ``nn.Dense``'s init: lecun-normal weights, zero bias."""
    fc = nn.Linear(in_f, out_f)
    lecun_normal_(fc.weight, generator)
    nn.init.zeros_(fc.bias)
    return fc


class ResNet50Classifier(nn.Module):
    """fb privacy predictor: ``backbone`` (ResNet-50) + ``fc`` (num_classes logits)
    (model_loaders.py:157-168). ``layers`` / ``width`` exist for the tiny variant."""

    def __init__(self, num_classes: int = 7, layers: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, *, generator: torch.Generator):
        super().__init__()
        self.backbone = ResNet2D("bottleneck", tuple(layers), depth=5, width=width,
                                 generator=generator)
        self.fc = _dense(self.backbone.channels[-1], num_classes, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(N, 3, H, W) -> (N, num_classes) logits, float32 (float64 for a float64 model)."""
        pooled = global_avg_pool(self.backbone(x.to(self.fc.weight.dtype), train)[-1])
        return at_least_f32(self.fc(pooled.to(self.fc.weight.dtype)))


class ResNet50SSL(nn.Module):
    """fb SimCLR model: ``backbone`` (ResNet-50 without fc) + ``proj_fc1`` -> ReLU ->
    ``proj_fc2`` (2048 -> 2048 -> 128), L2-normalized in float32
    (model_loaders.py:124-149): the projection NT-Xent compares."""

    def __init__(self, embedding_dim: int = 128, layers: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, *, generator: torch.Generator):
        super().__init__()
        self.backbone = ResNet2D("bottleneck", tuple(layers), depth=5, width=width,
                                 generator=generator)
        self.proj_fc1 = _dense(self.backbone.channels[-1], 2048, generator)
        self.proj_fc2 = _dense(2048, embedding_dim, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(N, 3, H, W) -> (N, embedding_dim), unit rows, float32 (float64 for a
        float64 model)."""
        dtype = self.proj_fc1.weight.dtype
        h = global_avg_pool(self.backbone(x.to(dtype), train)[-1])
        z = self.proj_fc2(F.relu(self.proj_fc1(h.to(dtype))))
        return l2_normalize(at_least_f32(z), dim=-1)
