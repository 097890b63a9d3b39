"""Utility model ft ``"r3d_18"``: torchvision's ``r3d_18`` video ResNet (counterpart of
ted_spad_tpu/models/r3d.py; reference use ``wrapper_r3d_18``, model_loaders.py:200-214).

Stem conv (3, 7, 7) stride (1, 2, 2) padding (1, 3, 3) + BN + ReLU; four layers of two
full-3D BasicBlocks (3^3 convs), 64/128/256/512 channels, stride 2 from the second
layer on; global average pool -> 512-d feature; fc. Layout NCDHW. Names follow the
flax module (``stem``, ``blocks_<i>``, ``fc``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ted_spad_tpu_torch.models.layers import ConvBN, global_avg_pool, lecun_normal_

FEATURE_DIM = 512


class BasicBlock3D(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int, downsample: bool, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.conv1 = ConvBN(inplanes, planes, (3, 3, 3), stride, 1, generator=g)
        self.conv2 = ConvBN(planes, planes, (3, 3, 3), 1, 1, act=False, generator=g)
        self.downsample = (ConvBN(inplanes, planes, (1, 1, 1), stride, act=False, generator=g)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + residual, inplace=True)


class R3D18(nn.Module):
    """``forward`` -> (logits, 512-d feature) like wrapper_r3d_18 (model_loaders.py:
    211-214); ``extract_features`` -> the feature."""

    def __init__(self, num_classes: int = 400, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.stem = ConvBN(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), generator=g)
        self.n_blocks = 0
        inplanes = 64
        for li, planes in enumerate((64, 128, 256, 512)):
            for bi in range(2):
                first = li > 0 and bi == 0
                self.add_module(f"blocks_{self.n_blocks}", BasicBlock3D(
                    inplanes, planes, 2 if first else 1, first, generator=g))
                self.n_blocks += 1
                inplanes = planes
        self.fc = nn.Linear(FEATURE_DIM, num_classes)
        lecun_normal_(self.fc.weight, g)
        nn.init.zeros_(self.fc.bias)

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, T, H, W) -> (B, 512) float32."""
        x = self.stem(x.to(self.stem.conv.weight.dtype))
        for i in range(self.n_blocks):
            x = getattr(self, f"blocks_{i}")(x)
        return global_avg_pool(x)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        feat = self.extract_features(x)
        return self.fc(feat.to(self.fc.weight.dtype)).float(), feat
