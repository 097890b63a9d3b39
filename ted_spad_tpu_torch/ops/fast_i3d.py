"""The space-to-depth (s2d) stem of I3Res50 (counterpart of ted_spad_tpu/ops/fast_i3d.py;
reference large_i3d.py:135).

The stem is a (5, 7, 7) stride-(2, 2, 2) conv with Cin = 3, a shape whose input channels
fill no tensor-core tile. Its spatial taps re-bin exactly onto a 2x2 space-to-depth grid:
with the clip viewed as (T, H/2, W/2, 12), the 7-tap stride-2 window becomes a 4-tap
stride-1 window over coarse pixels, fine tap k landing at coarse tap floor(k/2) + 2 with
parity k mod 2. A weight permutation: no extra multiply-adds, four times the input
channels. The stem's BatchNorm is folded into the conv, and the rest of the backbone
runs through the module from ``features_from_stem``.

``make_fast_ft_extract`` / ``make_fast_ft_forward`` are eval forms over the unchanged
``WrapperI3D``; any other model, train mode and odd frame sides run the module. With
``input_s2d`` the clips arrive already in the s2d layout (the UNet++ fast path's
``emit_s2d`` head writes it), so no relayout sits between the two models.
``make_fast_ft_train_forward`` is the train form: the s2d stem conv, the re-binning
inside the autograd graph, then the stem's BatchNorm as the module runs it in train
mode (the batch's statistics, or FrozenBN's running ones) and the module from
``forward_from_stem`` in train mode.

Layouts: frames NHWC, clips (B, C, T, H, W) in ``channels_last_3d`` memory. The s2d
channel order is (py, px, c)-major, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ted_spad_tpu_torch.models.layers import batch_norm, checkpoint
from ted_spad_tpu_torch.ops.fold import FoldCache, compute_dtype, fused_relu_ok
from ted_spad_tpu_torch.utils.device import at_least_f32

# Input channels of the s2d stem conv as the card runs it: the 12 s2d channels
# zero-padded to 16 (zero weights, so the result is exact). 12 is a channel count cuDNN's
# bf16 tensor-core kernels for 3D convolutions do not take.
_STEM_CIN = 16


def _move_channels(x: torch.Tensor, channel_dim: int) -> torch.Tensor:
    return x if channel_dim in (-1, x.dim() - 1) else x.movedim(channel_dim, -1)


def space_to_depth_2x2(x: torch.Tensor, channel_dim: int = -1) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/2, W/2, 4C) with (py, px, c)-major channels.
    ``channel_dim=1`` takes (B, C, T, H, W) clips and gives (B, 4C, T, H/2, W/2) in
    ``channels_last_3d`` memory (or (N, C, H, W) frames, ``channels_last``)."""
    y = _move_channels(x, channel_dim)
    *lead, h, w, c = y.shape
    y = y.reshape(*lead, h // 2, 2, w // 2, 2, c).transpose(-4, -3)
    y = y.reshape(*lead, h // 2, w // 2, 4 * c)
    return y if channel_dim in (-1, x.dim() - 1) else y.movedim(-1, channel_dim)


def depth_to_space_2x2(x: torch.Tensor, channel_dim: int = -1) -> torch.Tensor:
    """Inverse of ``space_to_depth_2x2``: (..., H, W, 4C) -> (..., 2H, 2W, C)."""
    y = _move_channels(x, channel_dim)
    *lead, h, w, c4 = y.shape
    c = c4 // 4
    y = y.reshape(*lead, h, w, 2, 2, c).transpose(-4, -3)
    y = y.reshape(*lead, 2 * h, 2 * w, c)
    return y if channel_dim in (-1, x.dim() - 1) else y.movedim(-1, channel_dim)


def _s2d_taps(k: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(coarse tap, parity, fine tap) of each of the k fine taps of a stride-2 window
    centred on tap k // 2: fine offset o = j - k // 2 lands at floor(o / 2) + 2, parity
    o mod 2. Made on ``device``: index tensors copied from the host would wait for the
    device's queue on every train-mode call."""
    j = torch.arange(k, device=device)
    o = j - k // 2
    return torch.div(o, 2, rounding_mode="floor") + 2, o % 2, j


def stem_s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """(5, 7, 7, 3, Cout) DHWIO -> (5, 4, 4, 12, Cout): the stem's taps re-binned for
    the s2d input; input channel block (qy, qx, c) matches ``space_to_depth_2x2``."""
    kt, kh, kw, cin, cout = w.shape
    assert (kh, kw, cin) == (7, 7, 3), w.shape
    a, q, j = _s2d_taps(7, w.device)
    ay, ax = a[:, None].expand(7, 7), a[None, :].expand(7, 7)
    qq = (q[:, None] * 2 + q[None, :])
    jy, jx = j[:, None].expand(7, 7), j[None, :].expand(7, 7)
    ws = w.new_zeros((kt, 4, 4, 4, cin, cout))
    ws[:, ay, ax, qq] = w[:, jy, jx]
    return ws.reshape(kt, 4, 4, 4 * cin, cout)


_CACHE = FoldCache()


def _stem_weights(stem, dtype: torch.dtype,
                  fold_bn: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The stem's s2d kernel, (Cout, 16, 5, 4, 4) in ``dtype`` (input channels beyond 12
    are zero), with its eval BatchNorm folded in (in float32, float64 for a float64
    module) and the folded bias in ``dtype``; without ``fold_bn`` the conv's own kernel
    and no bias."""
    bn, wide = stem.bn, at_least_f32
    ws = stem_s2d_kernel(wide(stem.conv.weight).permute(2, 3, 4, 1, 0))
    bias = None
    if fold_bn:
        scale = wide(bn.weight) / torch.sqrt(wide(bn.running_var) + bn.eps)
        bias = (wide(bn.bias) - wide(bn.running_mean) * scale).to(dtype)
        ws = ws * scale
    ws = F.pad(ws, (0, 0, 0, _STEM_CIN - ws.shape[-2]))
    wt = ws.permute(4, 3, 0, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last_3d)
    return wt, bias


def _stem_buffer(xs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """s2d clips (B, 12, T, H/2, W/2) in one zeroed ``channels_last_3d`` buffer with the
    stem's pads, (2, 2), (2, 1), (2, 1) (the fine (3, 3) pads on the coarse grid), and
    the zero channels up to 16 around them, so the stem conv runs unpadded."""
    b, c, t, h, w = xs.shape
    buf = torch.empty((b, _STEM_CIN, t + 4, h + 3, w + 3), dtype=dtype, device=xs.device,
                      memory_format=torch.channels_last_3d).zero_()
    buf[:, :c, 2:t + 2, 2:h + 2, 2:w + 2] = xs
    return buf


def s2d_stem(stem, xs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The stem (conv, eval BatchNorm, ReLU) on s2d clips (B, 12, T, H/2, W/2) ->
    (B, Cout, T/2, H/2, W/2), ``channels_last_3d``: a stride-(2, 1, 1) conv over
    ``_stem_buffer`` with the BatchNorm folded into its weights and bias."""
    wt, bias = _CACHE.get(stem, ("s2d_stem", dtype, xs.device),
                          lambda: _stem_weights(stem, dtype))
    buf = _stem_buffer(xs, dtype)
    if fused_relu_ok(buf, wt):
        return torch.cudnn_convolution_relu(buf, wt, bias, (2, 1, 1), (0, 0, 0), (1, 1, 1), 1)
    return F.relu_(F.conv3d(buf, wt, bias, stride=(2, 1, 1)))


def _make_fast(ft, from_stem: Callable, module_apply: Callable) -> Callable:
    """The shared factory: ``fast(x, train=False, input_s2d=False, **kw)`` runs the s2d
    stem, then ``from_stem(y, **kw)``; ``module_apply(x, train=, **kw)`` in train mode
    and at odd frame sides (after undoing an s2d input). Any model but ``WrapperI3D``
    gets ``module_apply`` itself."""
    from ted_spad_tpu_torch.models.i3res50 import WrapperI3D

    if not isinstance(ft, WrapperI3D):
        return module_apply
    stem = ft.i3d.stem

    def fast(x: torch.Tensor, train: bool = False, input_s2d: bool = False, **kw):
        if train or (not input_s2d and (x.shape[-1] % 2 or x.shape[-2] % 2)):
            if input_s2d:
                x = depth_to_space_2x2(x, channel_dim=1)
            return module_apply(x, train=train, **kw)
        dtype = compute_dtype(ft, x.device)
        xs = x.to(dtype) if input_s2d else space_to_depth_2x2(x.to(dtype), channel_dim=1)
        if kw.get("remat_blocks", False):
            y = checkpoint(lambda t: s2d_stem(stem, t, dtype), xs)
        else:
            y = s2d_stem(stem, xs, dtype)
        return from_stem(y, **kw)

    fast.supports_s2d = True
    return fast


def make_fast_ft_extract(ft) -> Callable:
    """``extract(clips, train=False, input_s2d=False)`` == the module's
    ``extract_features`` on (B, 3, T, H, W) clips (or s2d clips (B, 12, T, H/2, W/2)
    with ``input_s2d``), the stem computed s2d."""
    def module_apply(x, train=False, **kw):
        return ft.extract_features(x, train=train, **kw) if train else ft.extract_features(x)

    return _make_fast(ft, lambda y, **kw: ft.extract_features_from_stem(y, **kw), module_apply)


def make_fast_ft_forward(ft) -> Callable:
    """``forward(clips, train=False, input_s2d=False, remat_blocks=False) -> (logits,
    emb)`` == the module's ``forward`` in eval mode, the stem computed s2d; gradients
    flow to the clips (the re-binning is linear)."""
    def module_apply(x, train=False, **kw):
        return ft(x, train=train, **kw)

    return _make_fast(ft, lambda y, **kw: ft.forward_from_stem(y, **kw), module_apply)


def s2d_stem_conv(stem, xs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The stem's conv alone (no BatchNorm, no ReLU) on s2d clips, as ``s2d_stem`` runs
    it; the re-binned kernel is made inside the autograd graph, so the gradient reaches
    the (Cout, 3, 5, 7, 7) weight."""
    wt, _ = _stem_weights(stem, dtype, fold_bn=False)
    return F.conv3d(_stem_buffer(xs, dtype), wt, stride=(2, 1, 1))


def module_train_forward(ft) -> Callable:
    """``fwd(clips, generator=None, frozen_bn=False, remat_blocks=False) -> (logits, emb)``
    through the module's own train forward (``make_fast_ft_train_forward``'s fallback)."""
    def fwd(x, generator=None, frozen_bn=False, remat_blocks=False):
        kw = {"frozen_bn": True} if frozen_bn else {}
        return ft(x, train=True, generator=generator, remat_blocks=remat_blocks, **kw)

    return fwd


def make_fast_ft_train_forward(ft) -> Callable:
    """``fwd(clips, generator=None, frozen_bn=False, remat_blocks=False) -> (logits,
    emb)`` == the module's ``forward(clips, train=True, ...)`` on (B, 3, T, H, W) clips,
    the stem computed s2d: its conv (``s2d_stem_conv``), then the module's train-mode
    BatchNorm (``layers.batch_norm``): with ``frozen_bn=False`` the batch's statistics,
    the stem's running ones moved once, in place; with ``frozen_bn=True`` (FrozenBN) the
    running statistics as an affine, left as they are, its weight and bias still
    trained; then ReLU and ``forward_from_stem`` in train mode with ``generator``
    (dropout) and ``remat_blocks``, under which the stem is one more checkpointed
    piece. Any model but ``WrapperI3D``, and odd frame sides, run the module's own
    train forward."""
    from ted_spad_tpu_torch.models.i3res50 import WrapperI3D

    module_apply = module_train_forward(ft)
    if not isinstance(ft, WrapperI3D):
        return module_apply
    stem = ft.i3d.stem

    def fwd(x: torch.Tensor, generator=None, frozen_bn: bool = False, remat_blocks: bool = False):
        if x.shape[-1] % 2 or x.shape[-2] % 2:
            return module_apply(x, generator, frozen_bn, remat_blocks)
        dtype = compute_dtype(ft, x.device)

        def stem_fn(xs):
            y = batch_norm(stem.bn, s2d_stem_conv(stem, xs, dtype), train=True, frozen=frozen_bn)
            return F.relu(y, inplace=True)

        xs = space_to_depth_2x2(x.to(dtype), channel_dim=1)
        y = checkpoint(stem_fn, xs) if remat_blocks else stem_fn(xs)
        return ft.forward_from_stem(y, train=True, frozen_bn=frozen_bn, generator=generator,
                                    remat_blocks=remat_blocks)

    return fwd
