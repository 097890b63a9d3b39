"""Utility model ft: I3Res50 ("largei3d"), ResNet-50 inflated to 3D (counterpart of
ted_spad_tpu/models/i3res50.py; reference aux_code/models/large_i3d.py and the
wrapper and 128-d MLP head of aux_code/model_loaders.py:235-268).

- ``I3Res50.features`` -> the 2048-d pooled feature per clip (extract_features);
  ``I3Res50.forward`` -> (logits, feature), the logits through dropout and ``fc``.
- ``train`` uses and updates BN's batch statistics; ``frozen_bn`` (the reference's
  FrozenBN fine-tune mode, large_i3d.py:8-39) keeps the running statistics in train
  mode too while the affine parameters train. Dropout draws from an explicit
  ``torch.Generator``.
- ``WrapperI3D.forward`` -> (logits, 128-d L2-normalized embedding of ``MlpHead``).

Layout NCDHW (channels, time, height, width).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ted_spad_tpu_torch.models.layers import (
    ConvBN, batch_norm, checkpoint, dropout, global_avg_pool, lecun_normal_, max_pool_valid,
)
from ted_spad_tpu_torch.ops.losses import l2_normalize
from ted_spad_tpu_torch.utils.device import at_least_f32

# (planes, blocks, spatial_stride, temp_conv pattern) per layer (large_i3d.py:142-145).
_LAYER_SPECS = (
    (64, 3, 1, (1, 1, 1)),
    (128, 4, 2, (1, 0, 1, 0)),
    (256, 6, 2, (1, 0, 1, 0, 1, 0)),
    (512, 3, 2, (0, 1, 0)),
)


def _dense(in_f: int, out_f: int, generator: torch.Generator, bias: bool = True) -> nn.Linear:
    """flax ``nn.Dense``'s init: lecun-normal weights, zero bias."""
    fc = nn.Linear(in_f, out_f, bias=bias)
    lecun_normal_(fc.weight, generator)
    if bias:
        nn.init.zeros_(fc.bias)
    return fc


def _conv1x1(in_ch: int, out_ch: int, generator: torch.Generator) -> nn.Conv3d:
    """flax ``nn.Conv`` (1, 1, 1) with bias: lecun-normal weights, zero bias."""
    conv = nn.Conv3d(in_ch, out_ch, 1, bias=True)
    lecun_normal_(conv.weight, generator)
    nn.init.zeros_(conv.bias)
    return conv


class NonLocalBlock3D(nn.Module):
    """Non-local attention block (large_i3d.py:86-127): theta over every position,
    phi and g over a (1, 2, 2) max-pooled map, softmax(theta phi^T / sqrt(C/2)) g,
    then a 1x1x1 ConvBN (with bias) added to the input. ``use_nl=False`` in the
    shipped configuration (model_loaders.py:262)."""

    def __init__(self, dim_out: int, *, generator: torch.Generator):
        super().__init__()
        self.dim_inner = dim_out // 2
        self.theta = _conv1x1(dim_out, self.dim_inner, generator)
        self.phi = _conv1x1(dim_out, self.dim_inner, generator)
        self.g = _conv1x1(dim_out, self.dim_inner, generator)
        self.out = ConvBN(self.dim_inner, dim_out, (1, 1, 1), use_bias=True, act=False,
                          generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False) -> torch.Tensor:
        b, ci = x.shape[0], self.dim_inner
        mp = max_pool_valid(x, (1, 2, 2), (1, 2, 2))
        theta = self.theta(x)
        phi = self.phi(mp).reshape(b, ci, -1)
        g = self.g(mp).reshape(b, ci, -1).transpose(1, 2)  # (B, thw, Ci)
        sim = torch.matmul(theta.reshape(b, ci, -1).transpose(1, 2), phi) * ci ** -0.5
        t = torch.matmul(sim.softmax(dim=-1), g)  # (B, THW, Ci)
        t = t.transpose(1, 2).reshape(theta.shape)
        return self.out(t, train, frozen_bn) + x


class Bottleneck3D(nn.Module):
    """large_i3d.py:42-84: (1+2tc,1,1) temporal conv -> (1,3,3) spatial stride -> 1x1x1 x4,
    then the optional non-local block (``nl``)."""

    def __init__(self, inplanes: int, planes: int, stride: int, temp_conv: int,
                 downsample: bool, use_nl: bool = False, *, generator: torch.Generator):
        super().__init__()
        g, tc = generator, temp_conv
        self.conv1 = ConvBN(inplanes, planes, (1 + 2 * tc, 1, 1), 1, (tc, 0, 0), generator=g)
        self.conv2 = ConvBN(planes, planes, (1, 3, 3), (1, stride, stride), (0, 1, 1), generator=g)
        self.conv3 = ConvBN(planes, planes * 4, (1, 1, 1), act=False, generator=g)
        self.downsample = (
            ConvBN(inplanes, planes * 4, (1, 1, 1), (1, stride, stride), 0, act=False, generator=g)
            if downsample else None
        )
        self.nl = NonLocalBlock3D(planes * 4, generator=g) if use_nl else None

    def forward(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x, train, frozen_bn)
        out = self.conv1(x, train, frozen_bn)
        out = self.conv3(self.conv2(out, train, frozen_bn), train, frozen_bn)
        out = F.relu(out + residual, inplace=True)
        return out if self.nl is None else self.nl(out, train, frozen_bn)


class I3Res50(nn.Module):
    """The backbone (large_i3d.py:130-263) and its classifier. ``layer_specs`` /
    ``stem_width`` exist for the tiny test variant; the defaults are the reference
    architecture. Submodule names follow the flax module (``stem``,
    ``blocks_layer{L}_{B}``, ``fc``)."""

    def __init__(self, num_classes: int = 400, use_nl: bool = False, dropout_rate: float = 0.5,
                 layer_specs: tuple = _LAYER_SPECS, stem_width: int = 64, *,
                 generator: torch.Generator):
        super().__init__()
        self.layer_specs = layer_specs
        self.dropout_rate = dropout_rate
        self.stem = ConvBN(3, stem_width, (5, 7, 7), 2, (2, 3, 3), generator=generator)
        inplanes = stem_width
        for li, (planes, n_blocks, stride, temp_conv) in enumerate(layer_specs):
            nonlocal_mod = 2 if (use_nl and li in (1, 2)) else 1000
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                down = bi == 0 and (s != 1 or inplanes != planes * 4)
                self.add_module(
                    f"blocks_layer{li + 1}_{bi}",
                    Bottleneck3D(inplanes, planes, s, temp_conv[bi], down,
                                 use_nl=bi % nonlocal_mod == nonlocal_mod - 1, generator=generator),
                )
                inplanes = planes * 4
        self.fc = _dense(inplanes, num_classes, generator)

    def _layer(self, x: torch.Tensor, li: int, train: bool, frozen_bn: bool) -> torch.Tensor:
        for bi in range(self.layer_specs[li][1]):
            x = getattr(self, f"blocks_layer{li + 1}_{bi}")(x, train, frozen_bn)
        return x

    def features(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
                 remat_blocks: bool = False) -> torch.Tensor:
        """(B, 3, T, H, W) -> (B, 2048) float32 (== extract_features, large_i3d.py:249-263):
        the stem, then ``features_from_stem``. ``remat_blocks`` checkpoints the stem and
        each of the four stages on its own (``layers.checkpoint``): their outputs stay
        resident."""
        run = checkpoint if remat_blocks else (lambda fn, *a: fn(*a))
        x = run(lambda t: self.stem(t, train, frozen_bn), x.to(self.stem.conv.weight.dtype))
        return self.features_from_stem(x, train, frozen_bn, remat_blocks)

    def features_from_stem(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
                           remat_blocks: bool = False) -> torch.Tensor:
        """The backbone from the stem's output (B, 64, T/2, H/2, W/2) onward -> (B, 2048):
        the entry point of the space-to-depth stem (ops/fast_i3d.py), which computes the
        stem conv outside the module."""
        run = checkpoint if remat_blocks else (lambda fn, *a: fn(*a))
        x = max_pool_valid(x, (2, 3, 3), (2, 2, 2))
        x = run(lambda t: self._layer(t, 0, train, frozen_bn), x)
        x = max_pool_valid(x, (2, 1, 1), (2, 1, 1))
        for li in (1, 2, 3):
            x = run(lambda t, li=li: self._layer(t, li, train, frozen_bn), x)
        return global_avg_pool(x)

    def head(self, feat: torch.Tensor, train: bool = False,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """The logits from the pooled feature: dropout (train mode, ``generator``), then
        ``fc``; float32 (float64 for a float64 model)."""
        h = feat.to(self.fc.weight.dtype)
        if train:
            h = dropout(h, self.dropout_rate, generator)
        return at_least_f32(self.fc(h))

    def forward(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
                generator: torch.Generator | None = None, remat_blocks: bool = False):
        """(logits, pooled feature), float32 (float64 for a float64 model): the logits
        from the feature through dropout (train mode, ``generator``) and ``fc``."""
        feat = self.features(x, train, frozen_bn, remat_blocks)
        return self.head(feat, train, generator), feat


class MlpHead(nn.Module):
    """The 128-d temporal-distinctiveness embedding head (model_loaders.py:235-254):
    fc1 2048->512 (bias) -> BN -> ReLU -> fc2 512->128 (no bias) -> BN -> L2 norm."""

    def __init__(self, in_dim: int = 2048, embedding_dim: int = 128, *,
                 generator: torch.Generator):
        super().__init__()
        self.fc1 = _dense(in_dim, 512, generator)
        self.bn1 = nn.BatchNorm1d(512, eps=1e-5)
        self.fc2 = _dense(512, embedding_dim, generator, bias=False)
        self.bn2 = nn.BatchNorm1d(embedding_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(batch_norm(self.bn1, self.fc1(x.to(self.fc1.weight.dtype)), train))
        x = batch_norm(self.bn2, self.fc2(x), train)
        return l2_normalize(at_least_f32(x), dim=-1)


class WrapperI3D(nn.Module):
    """wrapper_i3d (model_loaders.py:258-268): ``i3d`` (I3Res50 with its classifier)
    and ``mlp`` (MlpHead). ``forward`` -> (logits, 128-d embedding);
    ``extract_features`` -> the 2048-d pooled feature."""

    def __init__(self, num_classes: int = 400, use_nl: bool = False, dropout_rate: float = 0.5,
                 layer_specs: tuple = _LAYER_SPECS, stem_width: int = 64, *,
                 generator: torch.Generator):
        super().__init__()
        self.i3d = I3Res50(num_classes, use_nl, dropout_rate, layer_specs, stem_width,
                           generator=generator)
        self.mlp = MlpHead(layer_specs[-1][0] * 4, generator=generator)

    def extract_features(self, x: torch.Tensor, train: bool = False,
                         frozen_bn: bool = False) -> torch.Tensor:
        return self.i3d.features(x, train, frozen_bn)

    def extract_features_from_stem(self, x: torch.Tensor, train: bool = False,
                                   frozen_bn: bool = False,
                                   remat_blocks: bool = False) -> torch.Tensor:
        """``extract_features`` from the stem's output onward (ops/fast_i3d.py)."""
        return self.i3d.features_from_stem(x, train, frozen_bn, remat_blocks)

    def forward(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
                generator: torch.Generator | None = None, remat_blocks: bool = False):
        logits, feat = self.i3d(x, train, frozen_bn, generator, remat_blocks)
        return logits, self.mlp(feat, train)

    def forward_from_stem(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
                          generator: torch.Generator | None = None,
                          remat_blocks: bool = False):
        """``forward``'s (logits, 128-d embedding) from the stem's output onward
        (ops/fast_i3d.py)."""
        feat = self.i3d.features_from_stem(x, train, frozen_bn, remat_blocks)
        return self.i3d.head(feat, train, generator), self.mlp(feat, train)
