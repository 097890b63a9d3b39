"""The UNet++ fast paths (counterpart of ted_spad_tpu/ops/fast_unetpp.py): exact
re-formulations of the module's eval and train forwards over the unchanged
``models.unet.UNetPlusPlus``, shared with the int8 serving mode (ops/quant_unetpp.py).

The identity everywhere here: ``conv3x3(nearest_up2(x), W)`` equals one conv of the
coarse ``x`` with re-binned taps, either the lhs-dilated 4x4 form (``up2_conv``, a
transposed conv with the flipped kernel) or the coarse 3x3 conv emitting (py, px,
cout)-major channels that ``depth_to_space`` unfolds (``up2_fuse_kernel``, the JAX
package's form, kept with its test; the decoder runs the transposed conv, which an H100
ran faster, PERF.md §6). The decoder never builds the upsampled tensors nor the dense-skip concatenations: each
block's conv1 is its up2 conv plus the skip convs' contributions, and the skip convs
that several blocks read run once, batched along Cout (``_decoder_schedule``).

``fast_unetpp_apply`` / ``make_fast_fa_apply``: the eval forward with every eval
BatchNorm folded into its conv (scale into the weights, shift into the conv bias), so
each conv is followed by at most an add and a ReLU; the inline ResNet-18 encoder
(``fast_encoder_apply``, its stem "plain" stride 2 or "s2d" on space-to-depth input);
and the head, plain (float32 (N, H, W, 3)) or ``emit_s2d``: a stride-2 4x4 conv that
writes the output in the 2x2 space-to-depth layout the I3Res50 s2d stem reads
(ops/fast_i3d.py). Folded weights are made from the module's current parameters and
kept only until any of them changes (``fold.FoldCache``).

``fast_unetpp_train_apply`` / ``fast_encoder_train_apply``: the train forward, the same
convolutions with BatchNorm on the batch's statistics (``layers.flax_batch_norm``, which
moves the running statistics in place), every kernel transform inside the autograd
graph so the gradients reach the module's own weights; nothing is folded or cached.
Under ``remat_blocks`` each of ``TRAIN_REMAT_SAVE_NAMES`` is checkpointed on its own.
``make_fast_fa_apply`` routes train calls there as the JAX package does.

Layout: activations NHWC (NCHW views of ``channels_last`` memory at the entry points),
kernels HWIO in float32 until they are laid out for a conv.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ted_spad_tpu_torch.models.layers import checkpoint, flax_batch_norm
from ted_spad_tpu_torch.ops.fast_i3d import depth_to_space_2x2, space_to_depth_2x2, stem_s2d_kernel
from ted_spad_tpu_torch.ops.fold import FoldCache, compute_dtype, fused_relu_ok
from ted_spad_tpu_torch.utils.device import at_least_f32

# Fine->coarse tap mixing per output parity of ``up2_fuse_kernel``: rows index the
# coarse offset (-1, 0, +1), columns the fine tap. Parity 0's fine taps {-1, 0, 1} land
# on coarse {-1, 0, 0}, parity 1's on {0, 0, +1}.
_M0 = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 1.0], [0.0, 0.0, 0.0]], np.float32)
_M1 = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)

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


@functools.lru_cache(maxsize=None)
def _up2_mixing(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``_DF`` on ``device`` in ``dtype``, copied there once: a copy from host memory
    waits for the device's queue, which a train step would otherwise do per block. Made
    outside inference mode, so that autograd may save it even when an inference-mode
    call made it first."""
    with torch.inference_mode(False):
        return torch.from_numpy(_DF).to(device, dtype)


def up2_dilated_kernel(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (4, 4, Cin, Cout) kernel K with
    ``conv(x, K, lhs_dilation=2, padding=2) == conv3x3_SAME(nearest_up2(x))``, as the JAX
    package's einsum forms it (the int8 mode's weight codes match JAX's bit for bit)."""
    d = _up2_mixing(w.device, w.dtype)
    return torch.einsum("ae,bf,efio->abio", d, d, w)


def up2_fuse_kernel(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (3, 3, Cin, 4 * Cout): conv-after-nearest-up2 as a coarse
    conv, output channels (py, px, cout)-major as ``depth_to_space`` reads them."""
    mats = [torch.from_numpy(m).to(w.device, w.dtype) for m in (_M0, _M1)]
    return torch.cat([torch.einsum("ae,bf,efio->abio", mats[py], mats[px], w)
                      for py in (0, 1) for px in (0, 1)], dim=-1)


def depth_to_space(y: torch.Tensor, cout: int) -> torch.Tensor:
    """(N, H, W, 4 * cout) with (py, px, c)-major channels -> (N, 2H, 2W, cout)."""
    assert y.shape[-1] == 4 * cout, (y.shape, cout)
    return depth_to_space_2x2(y)


def kernel(conv: torch.nn.Module) -> torch.Tensor:
    """A conv module's weight as a float32 HWIO / DHWIO kernel (float64 for a float64
    module)."""
    w = at_least_f32(conv.weight)
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


def _conv_wpack(x: torch.Tensor, w: torch.Tensor, r: int, dtype: torch.dtype) -> torch.Tensor:
    """The SAME conv3x3 of NHWC ``x`` with ``r`` consecutive output columns packed into
    channels: a (3, 2 + r, Cin, r * Cout) kernel at stride (1, r), (2 + r) / 3 times the
    multiply-adds for r times the output channels. Needs W % r == 0. Off every
    production path, as in the JAX package, where it was a TPU lane-width form that lost
    inside the decoder; kept with its test until a card shows it pays."""
    cout = w.shape[-1]
    wp = w.new_zeros((3, 2 + r, w.shape[2], r, cout))
    for j in range(r):
        wp[:, j:j + 3, :, j, :] += w
    y = conv_nhwc(x, wp.reshape(3, 2 + r, w.shape[2], r * cout), (1, r), ((1, 1), (1, r)), dtype)
    n, h, wr, _ = y.shape
    return y.reshape(n, h, wr * r, cout)


def _up2_layout(w44: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The (4, 4, Cin, Cout) lhs-dilated kernel as ``conv_transpose2d``'s (Cin, Cout, 4,
    4) weight: spatially flipped, ``channels_last``."""
    return w44.flip(0, 1).permute(2, 3, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)


def up2_conv(x: torch.Tensor, w44: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv(x, w44, lhs_dilation=(2, 2), padding=((2, 2), (2, 2)))`` in ``dtype`` on
    NHWC ``x``: a transposed convolution (stride 2, padding 1) with the spatially
    flipped kernel, so the zero-stuffed input is never built."""
    y = F.conv_transpose2d(x.to(dtype).movedim(-1, 1), _up2_layout(w44, dtype), stride=2, padding=1)
    return y.movedim(1, -1)


def stem2d_s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """(7, 7, 3, Cout) -> (4, 4, 12, Cout): the stride-2 stem's taps re-binned for
    space-to-depth input, input channel blocks (qy, qx, c) as ``space_to_depth_2x2``
    orders them (``fast_i3d.stem_s2d_kernel`` at one temporal tap)."""
    return stem_s2d_kernel(w[None])[0]


# The encoder stem's conv per mode, (stride, symmetric padding) over ``_stem_input``'s
# output: "plain" the stride-2 7x7 conv of the frames; "s2d" a 4x4 stride-1 conv over the
# space-to-depth frames with the taps of ``stem2d_s2d_kernel``, its asymmetric pads
# already in its input. The unfolded stem (``_stem_conv``) and the folded one
# (``_fold_encoder``) both take the stem from here.
_STEM_GEOMETRY = {"plain": (2, 3), "s2d": (1, 0)}


def _stem_kernel(w: torch.Tensor, mode: str) -> torch.Tensor:
    """The stem mode's kernel from the (7, 7, 3, Cout) HWIO kernel."""
    return stem2d_s2d_kernel(w) if mode == "s2d" else w


def _stem_input(frames: torch.Tensor, dtype: torch.dtype, mode: str) -> torch.Tensor:
    """NHWC frames in ``dtype`` as the stem mode's conv reads them."""
    x = frames.to(dtype)
    return F.pad(space_to_depth_2x2(x), (0, 0, 2, 1, 2, 1)) if mode == "s2d" else x


def _stem_conv(stem, frames: torch.Tensor, dtype: torch.dtype,
               weight: torch.Tensor | None = None, mode: str = "plain") -> torch.Tensor:
    """The stride-2 7x7 encoder stem conv (no BatchNorm): ``mode="plain"`` (the default,
    as in the JAX package) or ``"s2d"`` (``_STEM_GEOMETRY``). ``weight``: the mode's
    kernel already in ``dtype``, if the caller keeps one."""
    w = weight if weight is not None else _stem_kernel(kernel(stem.conv), mode)
    s, p = _STEM_GEOMETRY[mode]
    return conv_nhwc(_stem_input(frames, dtype, mode), w, (s, s), ((p, p), (p, p)), dtype)


def _resnet_maxpool(x: torch.Tensor) -> torch.Tensor:
    """torchvision's max pool k3 s2 with symmetric pad 1 on NHWC (-inf padding)."""
    return F.max_pool2d(x.movedim(-1, 1), 3, 2, padding=1).movedim(1, -1)


def encoder_layout_standard(encoder: torch.nn.Module) -> bool:
    """True iff the encoder is the reference ResNet-18 depth-4 layout the inline
    encoder is derived for: a (7, 7, 3, 64) stem, layer1..layer3 of exactly two blocks,
    no layer4."""
    stem = getattr(getattr(encoder, "stem", None), "conv", None)
    return (
        stem is not None
        and tuple(stem.weight.shape) == (64, 3, 7, 7)
        and all(hasattr(encoder, f"{ln}_{i}") for ln, nb, _ in _R18_ENC_LAYERS for i in range(nb))
        and not any(hasattr(encoder, f"{ln}_{nb}") for ln, nb, _ in _R18_ENC_LAYERS)
        and not hasattr(encoder, "layer4_0")
    )


def _bn_affine(bn: torch.nn.Module, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm folded to (scale, bias), in float32 (float64 for a float64
    module)."""
    scale = at_least_f32(bn.weight) / torch.sqrt(at_least_f32(bn.running_var) + eps)
    return scale, at_least_f32(bn.bias) - at_least_f32(bn.running_mean) * scale


def _pad_to(y: torch.Tensor, target_shape) -> torch.Tensor:
    """Centre-pad NHWC y's spatial dims to the target's (models/layers.pad_to_match)."""
    if tuple(y.shape[-3:-1]) == tuple(target_shape[-3:-1]):
        return y
    dh = target_shape[-3] - y.shape[-3]
    dw = target_shape[-2] - y.shape[-2]
    return F.pad(y, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


# The decoder's skip convs, batched along Cout: site -> the blocks whose conv1 reads
# that input, each with the slice of conv1's input channels it multiplies (the
# module's concat layout, conv1 input = [up(x), *skips]).
_SKIP_SITES = {
    "sk_f1": (("x_0_0", 256, 384),),
    "sk_f2": (("x_1_1", 128, 192), ("x_0_1", 320, 384)),
    "sk_f3": (("x_2_2", 64, 128), ("x_1_2", 128, 192), ("x_0_2", 256, 320)),
    "sk_x22": (("x_1_2", 64, 128), ("x_0_2", 192, 256)),
    "sk_x11": (("x_0_1", 256, 320),),
    "sk_x12": (("x_0_2", 128, 192),),
}


def skip_kernel(model, site: str) -> torch.Tensor:
    """The float32 HWIO kernel of a batched skip conv."""
    parts = [kernel(getattr(model, name).conv1.conv)[:, :, lo:hi, :]
             for name, lo, hi in _SKIP_SITES[site]]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _decoder_schedule(model, f: list, dtype: torch.dtype, block, conv=None):
    """The UNet++ nested-skip decoder with its multi-consumer skip convs batched along
    Cout (``_SKIP_SITES``): f[2] feeds x_1_1 + x_0_1, f[3] feeds x_2_2 + x_1_2 + x_0_2,
    and x_2_2 feeds x_1_2 + x_0_2.

    ``block(name, xin, skip_sum)`` runs one decoder block given its precomputed conv1
    skip contribution. ``conv(site, x, w)`` runs one skip conv (default: the plain conv
    in ``dtype``); ``w`` is a zero-argument callable giving the float32 HWIO kernel, so
    an executor that keeps its own (quantized or folded) copy computes it only once.
    Skip conv outputs are plain ``dtype`` tensors. Returns x_0_3 (full resolution,
    pre-head)."""
    if conv is None:
        def conv(site, x, w):
            return conv_nhwc(x, w(), (1, 1), ((1, 1), (1, 1)), dtype)

    def sk(site, x):
        return conv(site, x, lambda: skip_kernel(model, site))

    # The batched outputs are split, not sliced: a split's backward is one concatenation
    # of the parts' gradients, where each slice's would zero a buffer of the whole.
    x_0_0 = block("x_0_0", f[0], sk("sk_f1", f[1]))
    f2_11, f2_01 = sk("sk_f2", f[2]).split((64, 128), dim=-1)
    f3_22, f3_12, f3_02 = sk("sk_f3", f[3]).split(64, dim=-1)
    x_1_1 = block("x_1_1", f[1], f2_11)
    x_2_2 = block("x_2_2", f[2], f3_22)
    x22_12, x22_02 = sk("sk_x22", x_2_2).split(64, dim=-1)
    x_0_1 = block("x_0_1", x_0_0, sk("sk_x11", x_1_1) + f2_01)
    x_1_2 = block("x_1_2", x_1_1, x22_12 + f3_12)
    x_0_2 = block("x_0_2", x_0_1, sk("sk_x12", x_1_2) + x22_02 + f3_02)
    return block("x_0_3", x_0_2, None)


def head_s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (4, 4, Cin, 4 * Cout): the head as a stride-2 conv that
    writes its output in the 2x2 space-to-depth layout ((py, px, c)-major channels) the
    I3Res50 s2d stem reads (ops/fast_i3d.py)."""
    kh, kw, cin, cout = w.shape
    ws = w.new_zeros((4, 4, cin, 4, cout))
    for qy in (0, 1):
        for qx in (0, 1):
            ws[qy:qy + 3, qx:qx + 3, :, qy * 2 + qx, :] = w
    return ws.reshape(4, 4, cin, 4 * cout)


def _head_form(head: torch.nn.Module, emit_s2d: bool) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The head conv (padding 1) as (float32 HWIO kernel, float32 bias, stride): the 3x3
    conv, or with ``emit_s2d`` the stride-2 ``head_s2d_kernel`` form, its bias repeated
    for each parity. The unfolded head (``_apply_head``) and the folded one
    (``fold_unetpp``) both take the head from here."""
    w, b = kernel(head), at_least_f32(head.bias)
    return (head_s2d_kernel(w), b.repeat(4), 2) if emit_s2d else (w, b, 1)


def _apply_head(head: torch.nn.Module, x_0_3: torch.Tensor, in_h: int, in_w: int,
                dtype: torch.dtype, weight: torch.Tensor | None = None,
                emit_s2d: bool = False) -> torch.Tensor:
    """Pad x_0_3 back to the input resolution and apply the segmentation head in
    ``dtype``, its bias added after the conv: the 3x3 conv as a float32 (N, H, W, Cout)
    output, or with ``emit_s2d`` the stride-2 ``head_s2d_kernel`` form as a (N, H/2,
    W/2, 4 * Cout) output in ``dtype``. ``weight``: the form's kernel already in
    ``dtype``, if the caller keeps one."""
    w, b, s = _head_form(head, emit_s2d)
    w = weight if weight is not None else w
    out = conv_nhwc(_pad_to(x_0_3, (in_h, in_w, 0)), w, (s, s), ((1, 1), (1, 1)), dtype) + b.to(dtype)
    return out if emit_s2d else out.float()


# ---------------------------------------------------------------------------
# The eval forward with folded BatchNorm
# ---------------------------------------------------------------------------

class Conv(NamedTuple):
    """A conv laid out for torch: weight (O, I, kh, kw) in the compute dtype,
    ``channels_last``; bias in the compute dtype or None; stride; symmetric padding."""
    w: torch.Tensor
    b: torch.Tensor | None
    stride: int = 1
    padding: int = 1


def _layout(w_hwio: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return w_hwio.permute(3, 2, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)


def conv_run(x: torch.Tensor, c: Conv, z: torch.Tensor | None = None,
             relu: bool = False) -> torch.Tensor:
    """``c`` on NHWC ``x``, then ``+ z`` (NHWC, the output's shape) and ReLU: one cuDNN
    call with bias, ``z`` and ReLU fused where ``fold.fused_relu_ok`` allows (ReLU
    asked for), else the conv, an in-place add and an in-place ReLU. Returns an NHWC
    view of ``channels_last`` memory."""
    xt = x.movedim(-1, 1)
    if relu and fused_relu_ok(xt, c.w):
        args = ((c.stride,) * 2, (c.padding,) * 2, (1, 1), 1)
        if z is None:
            y = torch.cudnn_convolution_relu(xt, c.w, c.b, *args)
        else:
            y = torch.cudnn_convolution_add_relu(xt, c.w, z.movedim(-1, 1), 1.0, c.b, *args)
        return y.movedim(1, -1)
    y = F.conv2d(xt, c.w, c.b, stride=c.stride, padding=c.padding)
    if z is not None:
        y = y.add_(z.movedim(-1, 1))
    return (y.relu_() if relu else y).movedim(1, -1)


def _folded(convbn, dtype: torch.dtype, stride: int = 1, padding: int = 1,
            extra_bias: torch.Tensor | None = None) -> Conv:
    """A conv + eval BatchNorm module as one conv: BN's scale folded into the weights in
    float32, its shift (and the conv's own bias, scaled, and ``extra_bias``) into the
    conv bias."""
    scale, bias = _bn_affine(convbn.bn)
    if convbn.conv.bias is not None:
        bias = bias + at_least_f32(convbn.conv.bias) * scale
    if extra_bias is not None:
        bias = bias + extra_bias
    return Conv(_layout(kernel(convbn.conv) * scale, dtype), bias.to(dtype), stride, padding)


def _fold_encoder(encoder, dtype: torch.dtype, stem_mode: str) -> dict:
    """The encoder's convs with their BN folded. A block's downsample runs without bias:
    its shift joins conv2's, whose fused epilogue adds the residual."""
    scale, bias = _bn_affine(encoder.stem.bn)
    w = _stem_kernel(kernel(encoder.stem.conv) * scale, stem_mode)
    out = {"stem": Conv(_layout(w, dtype), bias.to(dtype), *_STEM_GEOMETRY[stem_mode])}
    for lname, nblocks, stride in _R18_ENC_LAYERS:
        for i in range(nblocks):
            blk, s, key = getattr(encoder, f"{lname}_{i}"), stride if i == 0 else 1, f"{lname}_{i}"
            out[f"{key}.conv1"] = _folded(blk.conv1, dtype, s)
            shift = None
            if blk.downsample is not None:
                ds = _folded(blk.downsample, dtype, s, 0)
                out[f"{key}.downsample"] = ds._replace(b=None)
                shift = _bn_affine(blk.downsample.bn)[1]
            out[f"{key}.conv2"] = _folded(blk.conv2, dtype, extra_bias=shift)
    return out


# The fused decoder's skip convs: (block, input) -> that input's slice of the block's
# conv1 input channels (from ``_SKIP_SITES``). Each block's last skip conv carries the
# block's conv1 BN shift and its ReLU, with the up2 conv and the other skip convs' sum
# added in its epilogue; the f3 parts of x_1_2 and x_0_2 run as one conv.
#
# Why the fused decoder does not run ``_decoder_schedule``: that schedule batches the
# skip convs of one input across all the blocks that read it and hands each block the
# sum, so every block would then add that sum, its BN shift and its ReLU in passes of
# their own over its full-size conv1 output. Here one skip conv of each block runs alone
# so that cuDNN's epilogue does that work, which splits the batched sites of
# ``_SKIP_SITES`` differently.
_SITE_INPUT = {"sk_f1": "f1", "sk_f2": "f2", "sk_f3": "f3", "sk_x22": "x_2_2",
               "sk_x11": "x_1_1", "sk_x12": "x_1_2"}
_PARTS = {(name, _SITE_INPUT[site]): (lo, hi)
          for site, parts in _SKIP_SITES.items() for name, lo, hi in parts}
_LAST_SKIP = {"x_0_0": "f1", "x_1_1": "f2", "x_2_2": "f3", "x_0_1": "x_1_1",
              "x_1_2": "x_2_2", "x_0_2": "x_1_2"}
_DEC_BLOCKS = ("x_0_0", "x_1_1", "x_2_2", "x_0_1", "x_1_2", "x_0_2", "x_0_3")


def fold_unetpp(model, dtype: torch.dtype, stem_mode: str = "plain",
                inline_encoder: bool = True) -> dict:
    """Every conv of the eval forward with its BatchNorm folded, laid out in ``dtype``:
    the inline encoder's (``inline_encoder``); per decoder block its up2 conv (conv1's
    up-path channels scaled by conv1's BN), its skip convs (each input's channels scaled
    alike; the last one with conv1's BN shift as its bias, x_0_3's shift kept alone as
    ``x_0_3.shift``) and conv2; both head forms."""
    out = _fold_encoder(model.encoder, dtype, stem_mode) if inline_encoder else {}
    for name in _DEC_BLOCKS:
        blk = getattr(model, name)
        sc, shift = _bn_affine(blk.conv1.bn)
        w1 = kernel(blk.conv1.conv) * sc
        cx = min([lo for (n, _), (lo, _) in _PARTS.items() if n == name],
                 default=w1.shape[2])
        out[f"{name}.up2"] = Conv(_up2_layout(up2_dilated_kernel(w1[:, :, :cx]), dtype), None, 2, 1)
        for (n, src), (lo, hi) in _PARTS.items():
            if n == name and (src != "f3" or name == "x_2_2"):
                bias = shift.to(dtype) if _LAST_SKIP[name] == src else None
                out[f"{name}.{src}"] = Conv(_layout(w1[:, :, lo:hi], dtype), bias)
        if name == "x_0_3":
            out["x_0_3.shift"] = shift.to(dtype)
        out[f"{name}.conv2"] = _folded(blk.conv2, dtype)
    f3 = torch.cat([kernel(getattr(model, n).conv1.conv)[:, :, lo:hi] * _bn_affine(
        getattr(model, n).conv1.bn)[0] for n in ("x_1_2", "x_0_2")
        for lo, hi in [_PARTS[(n, "f3")]]], dim=-1)
    out["f3.x_1_2+x_0_2"] = Conv(_layout(f3, dtype), None)
    for key, emit_s2d in (("head", False), ("head_s2d", True)):
        w, b, stride = _head_form(model.head, emit_s2d)
        out[key] = Conv(_layout(w, dtype), b.to(dtype), stride, 1)
    return out


def _basic_block_eval(x: torch.Tensor, wts: dict, key: str) -> torch.Tensor:
    """torchvision BasicBlock's eval forward with folded BN: conv1 + ReLU, then conv2
    with the residual (the input, or its folded 1x1 downsample) added and ReLU."""
    r = conv_run(x, wts[f"{key}.downsample"]) if f"{key}.downsample" in wts else x
    return conv_run(conv_run(x, wts[f"{key}.conv1"], relu=True), wts[f"{key}.conv2"], z=r,
                    relu=True)


def _encoder_from_folded(frames: torch.Tensor, wts: dict, dtype: torch.dtype,
                         stem_mode: str) -> list:
    f1 = conv_run(_stem_input(frames, dtype, stem_mode), wts["stem"], relu=True)
    x = _resnet_maxpool(f1)
    feats = [f1]
    for lname, nblocks, _ in _R18_ENC_LAYERS:
        for i in range(nblocks):
            x = _basic_block_eval(x, wts, f"{lname}_{i}")
        feats.append(x)
    return feats


def fast_encoder_apply(encoder, frames: torch.Tensor, dtype: torch.dtype,
                       stem_mode: str = "plain") -> list:
    """Eval forward of the ResNet-18 encoder (inline, folded BN) on NHWC frames: the
    stage features [stem (/2, 64), layer1 (/4, 64), layer2 (/8, 128), layer3 (/16,
    256)], NHWC, == the module's feature list without its input."""
    return _encoder_from_folded(frames, _fold_encoder(encoder, dtype, stem_mode), dtype,
                                stem_mode)


def _up_block_parts(x: torch.Tensor, wts: dict, name: str, inputs: dict, parts=()) -> torch.Tensor:
    """One decoder block: its up2 conv of ``x``, plus ``parts`` (skip contributions
    computed elsewhere, e.g. slices of a batched skip conv), as the epilogue input of its
    last skip conv (conv1's BN shift and ReLU fused there); x_0_3, which has no skip,
    adds its shift and ReLU in place. Then conv2 with its BN folded and ReLU."""
    last = _LAST_SKIP.get(name)
    up2 = wts[f"{name}.up2"]  # conv3x3 of the nearest up2 of x, exactly (``up2_conv``)
    y = F.conv_transpose2d(x.movedim(-1, 1), up2.w, None, up2.stride, up2.padding).movedim(1, -1)
    if last is None:
        y = y.add_(wts[f"{name}.shift"]).relu_()
    else:
        skip = inputs[last]
        y = _pad_to(y, skip.shape)
        for part in parts:
            y = y.add_(part)
        y = conv_run(skip, wts[f"{name}.{last}"], z=y, relu=True)
    return conv_run(y, wts[f"{name}.conv2"], relu=True)


def _fused_decoder(f: list, wts: dict) -> torch.Tensor:
    """The nested-skip decoder over the encoder features f = [/16, /8, /4, /2]; returns
    x_0_3 (full resolution, pre-head)."""
    t = {"f1": f[1], "f2": f[2], "f3": f[3]}

    def block(name, x, *parts):
        return _up_block_parts(x, wts, name, t, parts)

    t["x_0_0"] = block("x_0_0", f[0])
    t["x_1_1"] = block("x_1_1", f[1])
    t["x_2_2"] = block("x_2_2", f[2])
    f3c = conv_run(f[3], wts["f3.x_1_2+x_0_2"])
    t["x_0_1"] = block("x_0_1", t["x_0_0"], conv_run(f[2], wts["x_0_1.f2"]))
    t["x_1_2"] = block("x_1_2", t["x_1_1"], f3c[..., :64])
    t["x_0_2"] = block("x_0_2", t["x_0_1"], conv_run(t["x_2_2"], wts["x_0_2.x_2_2"]),
                       f3c[..., 64:])
    return block("x_0_3", t["x_0_2"])


def _unetpp_from_folded(frames: torch.Tensor, wts: dict, dtype: torch.dtype,
                        encoder_apply, emit_s2d: bool, stem_mode: str) -> torch.Tensor:
    in_h, in_w = frames.shape[-3], frames.shape[-2]
    if encoder_apply is None:
        feats = _encoder_from_folded(frames, wts, dtype, stem_mode)
    else:
        feats = [t.to(dtype) for t in encoder_apply(frames)[1:]]
    x_0_3 = _pad_to(_fused_decoder(feats[::-1], wts), (in_h, in_w, 0))
    if emit_s2d:
        return conv_run(x_0_3, wts["head_s2d"])
    return conv_run(x_0_3, wts["head"]).float()


_CACHE = FoldCache()


def fast_unetpp_apply(model, frames: torch.Tensor, *, encoder_apply: Callable | None = None,
                      dtype: torch.dtype | None = None, emit_s2d: bool = False,
                      stem_mode: str = "plain") -> torch.Tensor:
    """Fused eval forward of the UNetPlusPlus on NHWC frames -> (N, H, W, 3) float32, or
    with ``emit_s2d`` (N, H/2, W/2, 12) in ``dtype`` in the s2d layout.
    ``encoder_apply``: None (the inline encoder; the caller has checked
    ``encoder_layout_standard``), else a callable (NHWC frames) -> the module encoder's
    NHWC feature list, its input at index 0. ``dtype``: default the module's compute
    dtype (``fold.compute_dtype``). Folded weights come from the module's current
    parameters (kept while none changes)."""
    dtype = dtype or compute_dtype(model, frames.device)
    key = ("unetpp", dtype, stem_mode, encoder_apply is None, frames.device)
    wts = _CACHE.get(model, key, lambda: fold_unetpp(model, dtype, stem_mode,
                                                     encoder_apply is None))
    return _unetpp_from_folded(frames, wts, dtype, encoder_apply, emit_s2d, stem_mode)


# ---------------------------------------------------------------------------
# The train forward: BatchNorm on the batch's statistics
# ---------------------------------------------------------------------------

# The pieces the train forward checkpoints one by one under ``remat_blocks``
# (``layers.checkpoint``), under the JAX package's names for them: the four encoder
# features (f0 the deepest, layer3's; f3 the stem's) and the seven decoder blocks. Their
# outputs stay resident and only their insides are recomputed in the backward, as under
# the JAX package's ``save_only_these_names`` policy over these names.
TRAIN_REMAT_SAVE_NAMES = (
    "fa_enc_f0",
    "fa_enc_f1",
    "fa_enc_f2",
    "fa_enc_f3",
    "fa_blk_x_0_0",
    "fa_blk_x_1_1",
    "fa_blk_x_2_2",
    "fa_blk_x_0_1",
    "fa_blk_x_1_2",
    "fa_blk_x_0_2",
    "fa_blk_x_0_3",
)


def _piece(name: str, remat_blocks: bool, fn: Callable, *args: torch.Tensor) -> torch.Tensor:
    """``fn(*args)``, the train forward's piece ``name`` (one of
    ``TRAIN_REMAT_SAVE_NAMES``), checkpointed on its own under ``remat_blocks``."""
    assert name in TRAIN_REMAT_SAVE_NAMES, name
    return checkpoint(fn, *args) if remat_blocks else fn(*args)


def _convbn_train(y: torch.Tensor, convbn, relu: bool = True) -> torch.Tensor:
    """A ConvBN's train-mode BatchNorm (then ReLU) on its conv's NHWC output ``y``:
    ``layers.flax_batch_norm``, the batch's statistics in float32 (float64 stays
    float64), the running ones moved in place; the output in ``y``'s dtype."""
    out = flax_batch_norm(convbn.bn, y.movedim(-1, 1))
    # ReLU in place before the NHWC view is taken: in place on a view, autograd would
    # record the view's replay and rebase ops for it.
    return (F.relu(out, inplace=True) if relu else out).movedim(1, -1)


def _module_conv(x: torch.Tensor, conv: torch.nn.Conv2d, dtype: torch.dtype, stride: int = 1,
                 padding: int = 1) -> torch.Tensor:
    """A conv module's own weight and bias on NHWC ``x`` in ``dtype``: the parameter goes
    to the conv as it is, so autocast casts it once per autocast region (its cast cache
    holds leaf tensors only), as it does for the module."""
    y = F.conv2d(x.to(dtype).movedim(-1, 1), conv.weight, conv.bias, stride, padding)
    return y.movedim(1, -1)


def _basic_block_train(x: torch.Tensor, blk, stride: int, dtype: torch.dtype) -> torch.Tensor:
    """torchvision BasicBlock's train forward on NHWC ``x``: conv1 + BN + ReLU, conv2 +
    BN, the residual (the input, or the 1x1 downsample + BN) added, ReLU."""
    y = _convbn_train(_module_conv(x, blk.conv1.conv, dtype, stride), blk.conv1)
    y = _convbn_train(_module_conv(y, blk.conv2.conv, dtype), blk.conv2, relu=False)
    r = x
    if blk.downsample is not None:
        r = _convbn_train(_module_conv(x, blk.downsample.conv, dtype, stride, 0), blk.downsample,
                          relu=False)
    return F.relu(y + r, inplace=True)


def fast_encoder_train_apply(encoder, frames: torch.Tensor, dtype: torch.dtype,
                             stem_mode: str = "plain", remat_blocks: bool = False) -> list:
    """Train forward of the ResNet-18 encoder (inline) on NHWC frames: the stage features
    [stem (/2, 64), layer1 (/4, 64), layer2 (/8, 128), layer3 (/16, 256)], NHWC, == the
    module's train-mode feature list without its input, its BN running statistics moved
    as the module's. Both stem modes' kernels are made from the (64, 3, 7, 7) weight
    inside the graph, so its gradient is the module's. ``remat_blocks`` checkpoints the
    stem and each stage on its own (the maxpool inside layer1's piece)."""
    def stem(x):
        y = _module_conv(x, encoder.stem.conv, dtype, 2, 3) if stem_mode == "plain" else \
            _stem_conv(encoder.stem, x, dtype, mode=stem_mode)
        return _convbn_train(y, encoder.stem)

    def stage(x, lname, nblocks, stride):
        if lname == "layer1":
            x = _resnet_maxpool(x)
        for i in range(nblocks):
            x = _basic_block_train(x, getattr(encoder, f"{lname}_{i}"), stride if i == 0 else 1,
                                   dtype)
        return x

    feats = [_piece("fa_enc_f3", remat_blocks, stem, frames)]
    for k, (lname, nblocks, stride) in enumerate(_R18_ENC_LAYERS):
        feats.append(_piece(f"fa_enc_f{2 - k}", remat_blocks,
                            lambda x, a=(lname, nblocks, stride): stage(x, *a), feats[-1]))
    return feats


def fast_unetpp_train_apply(model, frames: torch.Tensor, *,
                            encoder_apply: Callable | None = None,
                            remat_blocks: bool = False) -> torch.Tensor:
    """Train forward of the UNetPlusPlus on NHWC frames -> (N, H, W, 3) float32, the
    module's ``forward(train=True)`` in the fast form: the up2 convs as transposed
    convs, the skip convs batched along Cout (``_decoder_schedule``), no upsampled
    tensor or concatenation; BatchNorm on the batch's statistics, the running ones
    moved in place once. The result equals the module's in real arithmetic (the block's
    conv1 summed as up2 conv + skip convs rather than one conv of the concatenation).
    ``encoder_apply``: None (the inline encoder, ``fast_encoder_train_apply``), else a
    callable (NHWC frames) -> the module encoder's train-mode NHWC features, its input
    at index 0. Convolutions run in the module's compute dtype (``fold.compute_dtype``).
    ``remat_blocks``: each of ``TRAIN_REMAT_SAVE_NAMES`` checkpointed on its own."""
    dtype = compute_dtype(model, frames.device)
    in_h, in_w = frames.shape[-3], frames.shape[-2]
    if encoder_apply is None:
        feats = fast_encoder_train_apply(model.encoder, frames, dtype, remat_blocks=remat_blocks)
    else:
        feats = [t.to(dtype) for t in encoder_apply(frames)[1:]]

    # Each block's conv1 kernel split once along its input channels, into its up2 part
    # (key 0) and the parts its skip convs read (key: their first channel): the split's
    # backward is one concatenation into the weight's gradient, where a slice each would
    # zero and add buffers of the whole weight.
    parts = {}
    for name in _DEC_BLOCKS:
        w1 = kernel(getattr(model, name).conv1.conv)
        bounds = [0] + sorted(lo for (n, _), (lo, _) in _PARTS.items() if n == name) + [w1.shape[2]]
        sizes = [hi - lo for lo, hi in zip(bounds, bounds[1:])]
        parts.update({(name, lo): p for lo, p in zip(bounds, w1.split(sizes, dim=2))})

    def skip_conv(site, x, w):
        ks = [parts[(name, lo)] for name, lo, _ in _SKIP_SITES[site]]
        k = ks[0] if len(ks) == 1 else torch.cat(ks, dim=-1)
        return conv_nhwc(x, k, (1, 1), ((1, 1), (1, 1)), dtype)

    def block(name, xin, skip_sum):
        blk = getattr(model, name)

        def run(x, skip=None):
            y = up2_conv(x, up2_dilated_kernel(parts[(name, 0)]), dtype)
            if skip is not None:
                y = _pad_to(y, skip.shape) + skip
            y = _convbn_train(y, blk.conv1)
            return _convbn_train(_module_conv(y, blk.conv2.conv, dtype), blk.conv2)

        args = (xin,) if skip_sum is None else (xin, skip_sum)
        return _piece("fa_blk_" + name, remat_blocks, run, *args)

    x_0_3 = _decoder_schedule(model, feats[::-1], dtype, block, conv=skip_conv)
    return _module_conv(_pad_to(x_0_3, (in_h, in_w, 0)), model.head, dtype).float()


def decoder_channels(model) -> tuple[int, ...]:
    """A UNet++'s decoder widths, x_0_0's to x_0_3's."""
    return tuple(getattr(model, n).conv2.conv.out_channels
                 for n in ("x_0_0", "x_0_1", "x_0_2", "x_0_3"))


def make_fast_fa_apply(fa) -> Callable:
    """``apply(frames, train=False, emit_s2d=False, **kw)`` on the module's (N, 3, H, W)
    frames (``channels_last``) -> (N, 3, H, W) float32, or with ``emit_s2d`` (N, 12, H/2,
    W/2) in the compute dtype (both NCHW views of NHWC memory): the fused eval forward
    for the standard UNet++, the module otherwise, as the JAX package routes:

    - a fa that is not a UNetPlusPlus, or whose decoder is not (256, 128, 64, 32), runs
      the module (``kw`` passed on, e.g. a UNet's ``use_kernel``); ``emit_s2d`` raises;
    - ``train=True`` runs the train form (``fast_unetpp_train_apply``; ``kw`` may hold
      ``remat_blocks``), with any other keyword or ``emit_s2d`` the module;
    - a non-standard encoder runs the module encoder inside the fused decoder, in the
      train form in train mode;
    - sides 16 does not divide run the module; where the module runs for a call with
      ``emit_s2d``, ``space_to_depth_2x2`` of its output in the compute dtype follows.

    ``apply.supports_s2d``: whether ``emit_s2d`` feeds a 3-channel s2d stem."""
    from ted_spad_tpu_torch.models.unet import UNetPlusPlus

    if not isinstance(fa, UNetPlusPlus) or decoder_channels(fa) != (256, 128, 64, 32):
        def plain(frames, train=False, emit_s2d=False, **kw):
            if emit_s2d:
                raise ValueError("emit_s2d needs the fused UNet++ path")
            return fa(frames, train=True, **kw) if train else fa(frames, **kw)

        plain.supports_s2d = False
        return plain

    inline = encoder_layout_standard(fa.encoder)

    def encoder_apply(frames, **kw):
        feats = fa.encoder(frames.movedim(-1, 1).to(fa.head.weight.dtype), **kw)
        return [t.movedim(1, -1) for t in feats]

    def apply(frames, train=False, emit_s2d=False, **kw):
        h, w = frames.shape[-2], frames.shape[-1]
        if h % 16 or w % 16 or (train and (emit_s2d or set(kw) - {"remat_blocks"})):
            out = fa(frames, train=True, **kw) if train else fa(frames, **kw)
            if emit_s2d:
                out = space_to_depth_2x2(out.to(compute_dtype(fa, out.device)), channel_dim=1)
            return out
        if train:
            blocks = kw.get("remat_blocks", False)
            enc = None if inline else functools.partial(encoder_apply, train=True,
                                                        remat_blocks=blocks)
            out = fast_unetpp_train_apply(fa, frames.movedim(1, -1), encoder_apply=enc,
                                          remat_blocks=blocks)
            return out.movedim(-1, 1)
        out = fast_unetpp_apply(fa, frames.movedim(1, -1),
                                encoder_apply=None if inline else encoder_apply,
                                emit_s2d=emit_s2d)
        return out.movedim(-1, 1)

    apply.supports_s2d = fa.head.out_channels == 3
    return apply
