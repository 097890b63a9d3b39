"""MGFN (Magnitude-Contrastive Glance-and-Focus Network), train and inference
(counterpart of ted_spad_tpu/models/mgfn.py; reference
anomaly_detection_mgfn/models/mgfn.py and utils/utils.py).

Modules work channels-first ``(B, C, T)`` with Conv1d, as the reference does. The
public input keeps the JAX layout ``(B, ncrops, T, F+1)``: F features plus the
feature-magnitude channel. A validity ``mask`` (B, T) makes a bucket-padded forward
equal to the native-length one: padded keys leave the softmax and padded positions
are re-zeroed between layers, so zero-padding bleed matches a native run.

Train mode follows flax, not torch: ``train`` is an argument of ``forward`` (the
module's ``training`` flag is not read), Focus's BatchNorm normalises with the
biased batch variance and moves its running statistics as flax's
``BatchNorm(momentum=0.9)`` does, and the magnitude dropout draws its mask from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ted_spad_tpu_torch.models.layers import flax_batch_norm, magnitude_dropout
from ted_spad_tpu_torch.utils.device import at_least_f32


def _conv1d(in_ch: int, out_ch: int, kernel: int, generator: torch.Generator,
            use_bias: bool = True, groups: int = 1) -> nn.Conv1d:
    conv = nn.Conv1d(in_ch, out_ch, kernel, padding=kernel // 2, bias=use_bias, groups=groups)
    fan_in = (in_ch // groups) * kernel
    nn.init.normal_(conv.weight, 0.0, math.sqrt(1.0 / fan_in), generator=generator)
    if use_bias:
        nn.init.zeros_(conv.bias)
    return conv


def _rezero(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Keep pad positions exactly zero: (B, C, T) * mask (B, T)."""
    return x if mask is None else x * mask[:, None, :].to(x.dtype)


class ChannelLayerNorm(nn.Module):
    """utils.py:101-112: (x - mean) / (sqrt(biased var) + eps) * g + b over channels.
    The reference adds eps to the std, unlike torch LayerNorm; kept."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_f32(x)
        mean = xf.mean(dim=1, keepdim=True)
        std = xf.var(dim=1, unbiased=False, keepdim=True).sqrt()
        out = (xf - mean) / (std + self.eps) * self.g[:, None] + self.b[:, None]
        return out.to(x.dtype)


class FeedForward(nn.Module):
    """utils.py:114-121: LN -> 1x1 conv (dim*repe) -> GELU -> (dropout) -> 1x1 conv."""

    def __init__(self, dim: int, repe: int, *, generator: torch.Generator):
        super().__init__()
        self.norm = ChannelLayerNorm(dim)
        self.fc1 = _conv1d(dim, dim * repe, 1, generator)
        self.fc2 = _conv1d(dim * repe, dim, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class Glance(nn.Module):
    """Global multi-head self-attention over the temporal tokens (utils.py:150-180)."""

    def __init__(self, dim: int, heads: int, dim_head: int, *, generator: torch.Generator):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm = ChannelLayerNorm(dim)
        self.to_qkv = _conv1d(dim, inner * 3, 1, generator, use_bias=False)
        self.to_out = _conv1d(inner, dim, 1, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        del train  # no attention dropout (attention_dropout 0.0, as in the JAX package)
        b, _, t = x.shape
        q, k, v = self.to_qkv(self.norm(x)).chunk(3, dim=1)  # each (B, inner, T)

        def heads_view(z: torch.Tensor) -> torch.Tensor:  # -> (B, heads, T, dim_head)
            return z.reshape(b, self.heads, self.dim_head, t).transpose(2, 3)

        q, k, v = heads_view(q) * self.dim_head ** -0.5, heads_view(k), heads_view(v)
        sim = at_least_f32(torch.matmul(q, k.transpose(2, 3)))
        if mask is not None:
            sim = sim.masked_fill(~mask[:, None, None, :], float("-inf"))
        attn = sim.softmax(dim=-1).to(v.dtype)
        out = torch.matmul(attn, v)  # (B, heads, T, dim_head)
        return self.to_out(out.transpose(2, 3).reshape(b, self.heads * self.dim_head, t))


class Focus(nn.Module):
    """Local per-head temporal aggregation (utils.py:124-147): BN -> 1x1 to_v ->
    grouped conv1d (groups=heads, kernel 5) over the ``heads`` channels that share a
    dim_head slot -> 1x1 to_out. Channel i of to_v's output is (slot i // heads,
    head i % heads), as the reference's rearrange 'b (c h) t -> (b c) h t'."""

    def __init__(self, dim: int, heads: int, dim_head: int, kernel: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm = nn.BatchNorm1d(dim, eps=1e-5)
        self.to_v = _conv1d(dim, inner, 1, generator, use_bias=False)
        self.rel_pos = _conv1d(heads, heads, kernel, generator, groups=heads)
        self.to_out = _conv1d(inner, dim, 1, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        b, _, t = x.shape
        # Eval BN maps zero pads to a nonzero constant; re-zero them before the
        # kernel-5 rel_pos conv so pad taps act as a native run's zero padding.
        bn = self.norm
        h = (flax_batch_norm(bn, x) if train else
             F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps))
        h = _rezero(h, mask)
        v = self.to_v(h).reshape(b * self.dim_head, self.heads, t)
        out = self.rel_pos(v).reshape(b, self.heads * self.dim_head, t)
        return self.to_out(out)


class Backbone(nn.Module):
    """depth x [conv3 residual -> attention residual -> FF residual] (mgfn.py:88-126)."""

    def __init__(self, dim: int, depth: int, heads: int, mgfn_type: str, kernel: int = 5,
                 dim_head: int = 64, ff_repe: int = 4, *, generator: torch.Generator):
        super().__init__()
        if mgfn_type not in ("gb", "fb"):
            raise ValueError(f"unknown mgfn_type {mgfn_type}")
        self.depth = depth
        g = generator
        for i in range(depth):
            self.add_module(f"scc{i}", _conv1d(dim, dim, 3, g))
            attn = (Glance(dim, heads, dim_head, generator=g) if mgfn_type == "gb"
                    else Focus(dim, heads, dim_head, kernel, generator=g))
            self.add_module(f"attn{i}", attn)
            self.add_module(f"ff{i}", FeedForward(dim, ff_repe, generator=g))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        for i in range(self.depth):
            x = _rezero(getattr(self, f"scc{i}")(x) + x, mask)
            x = _rezero(getattr(self, f"attn{i}")(x, mask, train) + x, mask)
            x = _rezero(getattr(self, f"ff{i}")(x) + x, mask)
        return x


def msnsd(features: torch.Tensor, scores: torch.Tensor, ncrops: int, k: int, *,
          inference: bool = True, dropout_rate: float = 0.0,
          generator: torch.Generator | None = None):
    """Magnitude Selection aNd Score prediction (mgfn.py:18-86).

    ``features`` (bs*ncrops, T, F) last-stage tokens; ``scores`` (bs*ncrops, T, 1).
    Train (``inference=False``): bs = 2*batch, the first half normal, the second
    abnormal; each half picks its top-k snippets by feature magnitude times a
    magnitude-dropout mask (abnormal half drawn first, as in JAX). Inference: the
    normal branch is reused for both halves (mgfn.py:54-57), with no dropout.

    Returns (score_abnormal (batch,1), score_normal (batch,1), abn_feamagnitude
    (ncrops*batch, k, F), nor_feamagnitude, scores (bs, T, 1)).

    Ties: where fewer than k positions survive the dropout, or fewer than k tokens
    have a non-zero magnitude, zeros tie. The picks are the first k of a stable
    descending sort, so among ties the lowest indices come first, as
    ``lax.top_k``'s."""
    bc, t, f = features.shape
    bs = bc // ncrops
    batch = bs if inference else bs // 2
    scores = scores.reshape(bs, ncrops, t).mean(dim=1)[..., None]  # (bs, T, 1)
    feat_mag = torch.linalg.vector_norm(at_least_f32(features), dim=2)  # (bs*ncrops, T)
    feat_mag = feat_mag.reshape(bs, ncrops, t).mean(dim=1)  # (bs, T)
    feats = features.reshape(bs, ncrops, t, f)

    def select(lo: int, hi: int):
        mag = feat_mag[lo:hi]
        if not inference:
            drop = magnitude_dropout(mag.shape, dropout_rate, generator, mag.device)
            mag = mag if drop is None else mag * drop
        idx = torch.sort(mag, dim=1, descending=True, stable=True).indices[:, :k]  # (batch, k)
        # Crop-major concat ordering as the reference's per-crop loop (mgfn.py:61-66).
        sel = torch.gather(feats[lo:hi], 2, idx[:, None, :, None].expand(hi - lo, ncrops, k, f))
        sel = sel.transpose(0, 1).reshape(ncrops * (hi - lo), k, f)
        return sel, torch.gather(scores[lo:hi], 1, idx[..., None]).mean(dim=1)  # (batch, 1)

    if inference:
        sel, sel_scores = select(0, batch)
        return sel_scores, sel_scores, sel, sel, scores
    abn, score_abnormal = select(batch, bs)
    nor, score_normal = select(0, batch)
    return score_abnormal, score_normal, abn, nor, scores


class MGFN(nn.Module):
    """mgfn.py:130-202. ``forward(video (B, ncrops, T, F+1), mask=None, *, train=False,
    inference=None, generator=None)`` -> (score_abnormal, score_normal,
    abn_feamagnitude, nor_feamagnitude, scores). ``inference`` defaults to ``not
    train``; a train batch is ``[normal; abnormal]``."""

    def __init__(
        self,
        feature_size: int = 2048,
        dims: Sequence[int] = (64, 128, 1024),
        depths: Sequence[int] = (3, 3, 2),
        mgfn_types: Sequence[str] = ("gb", "fb", "fb"),
        local_kernel: int = 5,
        ff_repe: int = 4,
        dim_head: int = 64,
        mag_ratio: float = 0.1,
        dropout_rate: float = 0.7,
        k: int = 3,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        g = generator
        self.feature_size, self.mag_ratio, self.k = feature_size, mag_ratio, k
        self.dropout_rate = dropout_rate
        self.n_stages = len(dims)
        self.to_tokens = _conv1d(feature_size, dims[0], 3, g)
        self.to_mag = _conv1d(1, dims[0], 3, g)
        for i, (dim, depth, mtype) in enumerate(zip(dims, depths, mgfn_types)):
            self.add_module(f"stage{i}", Backbone(dim, depth, dim // dim_head, mtype, local_kernel,
                                                  dim_head, ff_repe, generator=g))
            if i < len(dims) - 1:
                self.add_module(f"transition_norm{i}", ChannelLayerNorm(dim))
                self.add_module(f"transition_conv{i}", _conv1d(dim, dims[i + 1], 1, g))
        # to_logits: standard LayerNorm over channels (flax default eps 1e-6).
        self.to_logits_norm = nn.LayerNorm(dims[-1], eps=1e-6)
        self.fc = nn.Linear(dims[-1], 1)
        nn.init.normal_(self.fc.weight, 0.0, math.sqrt(1.0 / dims[-1]), generator=g)
        nn.init.zeros_(self.fc.bias)

    def forward(self, video: torch.Tensor, mask: torch.Tensor | None = None, *,
                train: bool = False, inference: bool | None = None,
                generator: torch.Generator | None = None):
        bs, ncrops, t, c = video.shape
        if c != self.feature_size + 1:
            raise ValueError(f"expected {self.feature_size + 1} channels (F+1), got {c}")
        x = video.reshape(bs * ncrops, t, c)
        cmask = None
        if mask is not None:
            cmask = mask.to(torch.bool).repeat_interleave(ncrops, dim=0)  # (bs*ncrops, T)
            x = x * cmask[..., None].to(x.dtype)
        x = x.transpose(1, 2)  # (B', F+1, T)
        x_f = self.to_tokens(x[:, : self.feature_size]) + self.mag_ratio * self.to_mag(
            x[:, self.feature_size :])
        x_f = _rezero(x_f, cmask)
        for i in range(self.n_stages):
            x_f = getattr(self, f"stage{i}")(x_f, cmask, train)
            if i < self.n_stages - 1:
                x_f = getattr(self, f"transition_norm{i}")(x_f)
                x_f = _rezero(getattr(self, f"transition_conv{i}")(x_f), cmask)
        tokens = self.to_logits_norm(x_f.transpose(1, 2))  # (B', T, C)
        scores = torch.sigmoid(at_least_f32(self.fc(tokens)))  # (B', T, 1)
        return msnsd(at_least_f32(tokens), scores, ncrops, self.k,
                     inference=not train if inference is None else inference,
                     dropout_rate=self.dropout_rate if train else 0.0, generator=generator)
