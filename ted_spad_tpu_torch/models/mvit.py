"""Utility model ft ``"mvitv2"``: MViTv2-S (counterpart of ted_spad_tpu/models/mvit.py;
reference use ``wrapper_mvit``, model_loaders.py:217-232, torchvision's ``mvit_v2_s``).

Patch embed conv3d k(3, 7, 7) s(2, 4, 4) p(1, 3, 3); a class token; four stages of
[1, 2, 11, 2] blocks, widths 96 -> 768, heads 1 -> 8, with pooled multi-head attention:
- q, k and v are pooled per head: a depthwise 3^3 conv over ``head_dim`` channels
  shared by the heads, then LayerNorm over ``head_dim``, the class token included
  (it skips the conv); q strides (1, 2, 2) at a stage's first block, k and v
  (1, 8, 8) -> (1, 1, 1) by stage;
- the decomposed relative-position bias (T, H, W tables) goes onto the grid part of
  the scores, not the class token's row or column;
- the v2 residual pooling adds the pooled q to every row but the class token's.
The feature is the normed class token (768-d). Attention is plain ``matmul`` and
``softmax``: the JAX package computes it in XLA, with no hand kernel.

The rel-pos tables' sizes follow the token grids, so the module is built for one clip
shape (``clip_shape``, (T, H, W)) and refuses another. Layout NCDHW in, tokens (B, N, C)
inside. Names follow the flax module.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ted_spad_tpu_torch.models.layers import lecun_normal_

FEATURE_DIM = 768
LN_EPS = 1e-5


def _pooled(thw: tuple[int, int, int], stride) -> tuple[int, int, int]:
    """Token grid after a 3^3 conv with padding 1 and ``stride``."""
    return tuple((n - 1) // s + 1 for n, s in zip(thw, stride))


def _rel_pos_index(q_size: int, k_size: int) -> np.ndarray:
    """(q_size, k_size) rows of a decomposed rel-pos table, as the JAX module's
    ``_rel_pos_1d`` computes them (float32 offsets, truncated)."""
    ratio_q = max(k_size / q_size, 1.0)
    ratio_k = max(q_size / k_size, 1.0)
    qi = np.arange(q_size, dtype=np.float32)[:, None] * np.float32(ratio_q)
    ki = np.arange(k_size, dtype=np.float32)[None, :] * np.float32(ratio_k)
    return ((qi - ki) + np.float32((k_size - 1) * ratio_k)).astype(np.int64)


def _linear(d_in: int, d_out: int, g: torch.Generator) -> nn.Linear:
    layer = nn.Linear(d_in, d_out)
    lecun_normal_(layer.weight, g)
    nn.init.zeros_(layer.bias)
    return layer


class PooledAttention(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, heads: int, q_stride, kv_stride,
                 input_thw: tuple[int, int, int], *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.heads, self.head_dim = heads, dim_out // heads
        self.input_thw = tuple(input_thw)
        hd = self.head_dim
        self.qkv = _linear(dim_in, 3 * dim_out, g)
        for name, stride in (("pool_q", q_stride), ("pool_k", kv_stride), ("pool_v", kv_stride)):
            conv = nn.Conv3d(hd, hd, 3, tuple(stride), 1, groups=hd, bias=False)
            lecun_normal_(conv.weight, g)
            self.add_module(name, conv)
            self.add_module(f"{name}_norm", nn.LayerNorm(hd, eps=LN_EPS))
        self.q_thw = _pooled(input_thw, q_stride)
        k_thw = _pooled(input_thw, kv_stride)
        for axis, (nq, nk) in zip("thw", zip(self.q_thw, k_thw)):
            self.register_parameter(f"rel_pos_{axis}", nn.Parameter(torch.zeros(2 * max(nq, nk) - 1, hd)))
            self.register_buffer(f"rel_index_{axis}", torch.from_numpy(_rel_pos_index(nq, nk)),
                                 persistent=False)
        self.proj = _linear(dim_out, dim_out, g)

    def _pool(self, z: torch.Tensor, name: str, thw) -> tuple[torch.Tensor, tuple]:
        """(b, n, heads, hd) -> (b, heads, n', hd): heads folded into the batch, the
        grid through the depthwise conv, the class token beside it, both normed."""
        b, n = z.shape[:2]
        z = z.transpose(1, 2).reshape(b * self.heads, n, self.head_dim)
        grid = z[:, 1:].reshape(b * self.heads, *thw, self.head_dim).permute(0, 4, 1, 2, 3)
        grid = getattr(self, name)(grid)
        out_thw = tuple(grid.shape[2:])
        grid = grid.flatten(2).transpose(1, 2)
        z = getattr(self, f"{name}_norm")(torch.cat([z[:, :1], grid], dim=1))
        return z.reshape(b, self.heads, -1, self.head_dim), out_thw

    def forward(self, x: torch.Tensor, thw) -> tuple[torch.Tensor, tuple]:
        b, n, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, self.head_dim).unbind(2)
        qh, q_thw = self._pool(q, "pool_q", thw)
        kh, k_thw = self._pool(k, "pool_k", thw)
        vh, _ = self._pool(v, "pool_v", thw)
        attn = ((qh * self.head_dim ** -0.5) @ kh.transpose(-2, -1)).float()
        # Decomposed rel-pos bias on the grid part: (b, heads, qt, qh, qw, kt, kh, kw).
        q_grid = qh[:, :, 1:].reshape(b, self.heads, *q_thw, self.head_dim)
        bt = torch.einsum("bhtxyd,tkd->bhtxyk", q_grid, self.rel_pos_t[self.rel_index_t])
        bh = torch.einsum("bhtxyd,xkd->bhtxyk", q_grid, self.rel_pos_h[self.rel_index_h])
        bw = torch.einsum("bhtxyd,ykd->bhtxyk", q_grid, self.rel_pos_w[self.rel_index_w])
        bias = (bt[..., :, None, None] + bh[..., None, :, None] + bw[..., None, None, :]).float()
        attn[:, :, 1:, 1:] += bias.reshape(b, self.heads, int(np.prod(q_thw)), int(np.prod(k_thw)))
        out = attn.softmax(dim=-1).to(vh.dtype) @ vh
        out[:, :, 1:] += qh[:, :, 1:]  # residual pooling, the class token's row left out
        out = out.transpose(1, 2).reshape(b, qh.shape[2], self.heads * self.head_dim)
        return self.proj(out), q_thw


class MViTBlock(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, heads: int, q_stride, kv_stride,
                 input_thw: tuple[int, int, int], mlp_ratio: int = 4, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.q_stride = tuple(q_stride)
        self.norm1 = nn.LayerNorm(dim_in, eps=LN_EPS)
        self.attn = PooledAttention(dim_in, dim_out, heads, q_stride, kv_stride, input_thw,
                                    generator=g)
        # v2: the skip projection reads norm1's output (torchvision MultiscaleBlock).
        self.proj_skip = _linear(dim_in, dim_out, g) if dim_in != dim_out else None
        self.norm2 = nn.LayerNorm(dim_out, eps=LN_EPS)
        self.mlp_fc1 = _linear(dim_out, dim_out * mlp_ratio, g)
        self.mlp_fc2 = _linear(dim_out * mlp_ratio, dim_out, g)

    def forward(self, x: torch.Tensor, thw) -> tuple[torch.Tensor, tuple]:
        h = self.norm1(x)
        attn_out, new_thw = self.attn(h, thw)
        shortcut = x if self.proj_skip is None else self.proj_skip(h)
        if self.q_stride != (1, 1, 1):
            # The skip pools like q: kernel s + 1 (padding k // 2) where strided, else 1.
            b, _, c = shortcut.shape
            kernel = tuple(s + 1 if s > 1 else 1 for s in self.q_stride)
            grid = shortcut[:, 1:].reshape(b, *thw, c).permute(0, 4, 1, 2, 3)
            grid = F.max_pool3d(grid, kernel, self.q_stride, tuple(k // 2 for k in kernel))
            shortcut = torch.cat([shortcut[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)
        x = shortcut + attn_out
        h2 = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none"))
        return x + h2, new_thw


@dataclasses.dataclass(frozen=True)
class MViTv2Config:
    depths: tuple[int, ...] = (1, 2, 11, 2)
    dims: tuple[int, ...] = (96, 192, 384, 768)
    heads: tuple[int, ...] = (1, 2, 4, 8)
    kv_strides: tuple[tuple[int, int, int], ...] = ((1, 8, 8), (1, 4, 4), (1, 2, 2), (1, 1, 1))


class MViTv2S(nn.Module):
    """``forward`` -> (logits, 768-d feature) like wrapper_mvit (model_loaders.py:
    228-232); ``extract_features`` -> the feature (the normed class token, float32)."""

    def __init__(self, num_classes: int = 400, config: MViTv2Config = MViTv2Config(),
                 clip_shape: tuple[int, int, int] = (16, 224, 224), *,
                 generator: torch.Generator):
        super().__init__()
        g, cfg = generator, config
        self.patch_embed = nn.Conv3d(3, cfg.dims[0], (3, 7, 7), (2, 4, 4), (1, 3, 3))
        lecun_normal_(self.patch_embed.weight, g)
        nn.init.zeros_(self.patch_embed.bias)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.dims[0]))
        self.thw = _pooled_embed(clip_shape)
        self.block_names = []
        thw, dim_in = self.thw, cfg.dims[0]
        for si, depth in enumerate(cfg.depths):
            for bi in range(depth):
                q_stride = (1, 2, 2) if si > 0 and bi == 0 else (1, 1, 1)
                block = MViTBlock(dim_in, cfg.dims[si], cfg.heads[si], q_stride, cfg.kv_strides[si],
                                  thw, generator=g)
                self.block_names.append(f"stage{si}_block{bi}")
                self.add_module(self.block_names[-1], block)
                thw, dim_in = block.attn.q_thw, cfg.dims[si]
        self.norm = nn.LayerNorm(cfg.dims[-1], eps=LN_EPS)
        self.head = _linear(cfg.dims[-1], num_classes, g)

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, T, H, W) -> (B, dims[-1]) float32."""
        x = self.patch_embed(x.to(self.patch_embed.weight.dtype))
        thw = tuple(x.shape[2:])
        if thw != self.thw:
            raise ValueError(f"MViTv2S was built for a {self.thw} token grid (its rel-pos tables), "
                             f"this clip gives {thw}")
        tokens = torch.cat([self.cls_token.expand(x.shape[0], -1, -1).to(x.dtype),
                            x.flatten(2).transpose(1, 2)], dim=1)
        for name in self.block_names:
            tokens, thw = getattr(self, name)(tokens, thw)
        return self.norm(tokens)[:, 0].float()

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        feat = self.extract_features(x)
        return self.head(feat.to(self.head.weight.dtype)).float(), feat


def _pooled_embed(clip_shape: tuple[int, int, int]) -> tuple[int, int, int]:
    """Token grid of the patch embed: k (3, 7, 7), stride (2, 4, 4), padding (1, 3, 3)."""
    return tuple((n + 2 * p - k) // s + 1 for n, k, s, p in zip(clip_shape, (3, 7, 7), (2, 4, 4), (1, 3, 3)))
