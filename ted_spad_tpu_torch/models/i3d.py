"""Utility model ft ``"i3d"``: InceptionI3d, Inception-v1 inflated to 3D (counterpart
of ted_spad_tpu/models/i3d.py; reference aux_code/models/i3d.py), whose 1024-d
features XD-Violence's MGFN preset takes.

TF's dynamic SAME padding is kept: each Unit3D conv and max pool pads ``pad // 2``
in front and the rest behind, from the input's size (``layers.pad_tf_same``); max
pools pad with the dtype's lowest value. Unit3D's BatchNorm has eps 1e-3.
``extract_features``: trunk -> average pool (2, 7, 7) VALID -> mean, in float32, so a
clip needs at least 9 x 193 x 193 pixels. Layout NCDHW. Names follow the flax module.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ted_spad_tpu_torch.models.layers import kaiming_normal_fan_out_, max_pool_same, pad_tf_same

FEATURE_DIM = 1024
UNIT3D_BN_EPS = 1e-3  # torch BN(eps=0.001) of the reference (i3d.py:81)

# Inception endpoints in order: (b0, b1a, b1b, b2a, b2b, b3b) channels (i3d.py:168-306).
_MIXED_SPECS = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)


class Unit3D(nn.Module):
    """TF-SAME conv3d (no bias) -> BatchNorm (eps 1e-3, eval) -> ReLU (i3d.py:48-121)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), *, generator: torch.Generator):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.conv3d = nn.Conv3d(in_ch, out_ch, self.kernel, self.stride, bias=False)
        self.bn = nn.BatchNorm3d(out_ch, eps=UNIT3D_BN_EPS)
        kaiming_normal_fan_out_(self.conv3d.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(pad_tf_same(x, self.kernel, self.stride))
        return F.relu(self.bn(x), inplace=True)


class InceptionModule(nn.Module):
    """Four branches concatenated on channels (i3d.py:124-149)."""

    def __init__(self, in_ch: int, oc: Sequence[int], *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.b0 = Unit3D(in_ch, oc[0], generator=g)
        self.b1a = Unit3D(in_ch, oc[1], generator=g)
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3), generator=g)
        self.b2a = Unit3D(in_ch, oc[3], generator=g)
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3), generator=g)
        self.b3b = Unit3D(in_ch, oc[5], generator=g)
        self.out_ch = oc[0] + oc[2] + oc[4] + oc[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], dim=1)


class InceptionI3d(nn.Module):
    """i3d.py:152-340. ``forward`` -> (logits, 1024-d feature), as the JAX module's
    ``__call__``; ``extract_features`` -> the feature. Endpoint modules are named
    ``mixed_<endpoint>``, as flax names the entries of the JAX module's dict."""

    def __init__(self, num_classes: int = 400, dropout_rate: float = 0.5, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.conv_1a = Unit3D(3, 64, (7, 7, 7), (2, 2, 2), generator=g)
        self.conv_2b = Unit3D(64, 64, generator=g)
        self.conv_2c = Unit3D(64, 192, (3, 3, 3), generator=g)
        in_ch = 192
        for name, spec in _MIXED_SPECS:
            module = InceptionModule(in_ch, spec, generator=g)
            self.add_module(f"mixed_{name}", module)
            in_ch = module.out_ch
        # The reference passes dropout_keep_prob=0.5 as nn.Dropout(p): it drops half.
        self.dropout = nn.Dropout(dropout_rate)
        self.logits_conv = nn.Conv3d(FEATURE_DIM, num_classes, 1)
        kaiming_normal_fan_out_(self.logits_conv.weight, g)
        nn.init.zeros_(self.logits_conv.bias)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, T, H, W) -> the Mixed_5c map (B, 1024, ~T/8, ~H/32, ~W/32)."""
        x = self.conv_1a(x.to(self.conv_1a.conv3d.weight.dtype))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_2a_3x3
        x = self.conv_2c(self.conv_2b(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_3a_3x3
        for name, _ in _MIXED_SPECS:
            if name == "Mixed_4b":
                x = max_pool_same(x, (3, 3, 3), (2, 2, 2))  # MaxPool3d_4a_3x3
            elif name == "Mixed_5b":
                x = max_pool_same(x, (2, 2, 2), (2, 2, 2))  # MaxPool3d_5a_2x2
            x = getattr(self, f"mixed_{name}")(x)
        return x

    @staticmethod
    def extract_pooled(trunk_out: torch.Tensor) -> torch.Tensor:
        """Average pool (2, 7, 7), stride 1, VALID, then the mean over what is left, in
        float32 (i3d.py:336-340; dali_extraction.py:175-179): (B, 1024)."""
        if any(n < k for n, k in zip(trunk_out.shape[2:], (2, 7, 7))):
            raise ValueError(f"the i3d feature pools a (2, 7, 7) window of its trunk map, which is "
                             f"{tuple(trunk_out.shape[2:])}: the clip needs at least 9x193x193 pixels")
        f = F.avg_pool3d(trunk_out.float(), (2, 7, 7), 1)
        return f.flatten(2).mean(dim=2)

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.extract_pooled(self.trunk(x))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.trunk(x)
        feat = self.extract_pooled(x)
        pooled = x.float().mean(dim=(2, 3, 4), keepdim=True)  # adaptive average pool (1, 1, 1)
        logits = self.logits_conv(self.dropout(pooled.to(x.dtype)))
        return logits.reshape(x.shape[0], -1).float(), feat
