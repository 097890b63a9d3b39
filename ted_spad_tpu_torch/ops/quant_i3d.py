"""W8A8 int8 eval path of the I3Res50 ("largei3d") ft feature path for serving
(counterpart of ted_spad_tpu/ops/quant_i3d.py, with its ``i3d_`` site names letter for
letter).

The same scheme and the same ``_Quantizer`` as the fa path (ops/quant_unetpp.py): the
Bottleneck3D convolutions run int8 through kernel K4, with per-Cout weight scales and
calibrated per-tensor activation scales; BatchNorm, ReLU and requantization are torch
elementwise ops; the VALID max pools run on the int8 codes. The stem runs in the
compute dtype on the plain (B, T, H, W, 3) clip, or with ``stem_int8`` through K4 over
its 3 input channels (K zero-padded to 32). The JAX package runs its stem on a 2x2
space-to-depth layout; that is a permutation of the same products, so the int8 codes and
sums are the same. Layout NDHWC; the extract built by ``make_quant_ft_extract`` takes the
module's (B, 3, T, H, W) clips.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ted_spad_tpu_torch.ops.fast_unetpp import conv_nhwc, kernel
from ted_spad_tpu_torch.ops.quant_unetpp import QT, _affine_relu, _Quantizer

STEM_STRIDES = (2, 2, 2)
STEM_PADDING = ((2, 2), (3, 3), (3, 3))


def _qbottleneck(qz: _Quantizer, block, qx: QT, stride: int, tc: int, site: str) -> torch.Tensor:
    """Quantized Bottleneck3D eval forward: temporal (1+2tc, 1, 1) conv -> (1, 3, 3)
    spatial stride conv -> 1x1x1 expand, + residual. Returns the plain pre-quantization
    output (the caller owns the out site)."""
    y = qz.conv(qx, lambda: kernel(block.conv1.conv), f"{site}.conv1", strides=(1, 1, 1),
                padding=((tc, tc), (0, 0), (0, 0)))
    y = _affine_relu(y, qz.affine(f"{site}.conv1", block.conv1))
    yq = qz.q8(f"{site}_c1", y)
    y = qz.conv(yq, lambda: kernel(block.conv2.conv), f"{site}.conv2",
                strides=(1, stride, stride), padding=((0, 0), (1, 1), (1, 1)))
    y = _affine_relu(y, qz.affine(f"{site}.conv2", block.conv2))
    yq = qz.q8(f"{site}_c2", y)
    y = qz.conv(yq, lambda: kernel(block.conv3.conv), f"{site}.conv3", strides=(1, 1, 1),
                padding=((0, 0), (0, 0), (0, 0)))
    y = _affine_relu(y, qz.affine(f"{site}.conv3", block.conv3), relu=False)
    if block.downsample is not None:
        r = qz.conv(qx, lambda: kernel(block.downsample.conv), f"{site}.downsample",
                    strides=(1, stride, stride), padding=((0, 0), (0, 0), (0, 0)))
        r = _affine_relu(r, qz.affine(f"{site}.downsample", block.downsample), relu=False)
    else:
        r = qz.dequant(qx)
    return F.relu(y + r)


def _q_backbone(qz: _Quantizer, i3d, y: torch.Tensor) -> torch.Tensor:
    """Backbone from the stem's ReLU output (NDHWC) to the pooled (B, 2048) float32
    features."""
    layer_specs = i3d.layer_specs
    xq = qz.q8("i3d_in", y)
    xq = qz.maxpool_valid(xq, (2, 3, 3), (2, 2, 2))
    last = (len(layer_specs) - 1, layer_specs[-1][1] - 1)
    out = None
    for li, (_, n_blocks, stride, temp_conv) in enumerate(layer_specs):
        for bi in range(n_blocks):
            name = f"blocks_layer{li + 1}_{bi}"
            z = _qbottleneck(qz, getattr(i3d, name), xq, stride if bi == 0 else 1,
                             temp_conv[bi], f"i3d_l{li + 1}_{bi}")
            if (li, bi) == last:
                out = z  # feeds the float32 average pool: never quantized
            else:
                xq = qz.q8(f"i3d_l{li + 1}_{bi}_out", z)
        if li == 0:
            xq = qz.maxpool_valid(xq, (2, 1, 1), (2, 1, 1))
    return out.float().mean(dim=tuple(range(1, out.dim() - 1)))


def _q_features(qz: _Quantizer, ft_model, x: torch.Tensor, stem_int8: bool) -> torch.Tensor:
    """Stem + backbone + global average pool == I3Res50.features in eval mode, on NDHWC
    clips."""
    i3d = ft_model.i3d
    if stem_int8:
        xq = qz.q8("i3d_stem_in", x.to(qz.dtype))
        y = qz.conv(xq, lambda: kernel(i3d.stem.conv), "i3d.stem", strides=STEM_STRIDES,
                    padding=STEM_PADDING)
    else:
        w = qz.weight("i3d.stem", lambda: kernel(i3d.stem.conv).to(qz.dtype))
        y = conv_nhwc(x, w, STEM_STRIDES, STEM_PADDING, qz.dtype)
    y = _affine_relu(y, qz.affine("i3d.stem", i3d.stem))
    return _q_backbone(qz, i3d, y)


def _check_supported(ft_model) -> None:
    from ted_spad_tpu_torch.models.i3res50 import WrapperI3D

    if not isinstance(ft_model, WrapperI3D):
        raise ValueError("quantized ft supports the standard WrapperI3D (use_nl=False) only")


def _dtype(ft_model) -> torch.dtype:
    return ft_model.i3d.stem.conv.weight.dtype


def calibrate_i3d(ft_model, x: torch.Tensor):
    """Calibration pass of the ft feature path: the quantization schedule in the
    module's dtype over NDHWC clips, returning ``(feat (B, 2048), {site: absmax})``,
    including the stem input's absmax (so run mode can turn ``stem_int8`` on without a
    second pass)."""
    _check_supported(ft_model)
    qz = _Quantizer("calib", None, _dtype(ft_model))
    feat = _q_features(qz, ft_model, x, stem_int8=False)
    qz.q8("i3d_stem_in", x.to(qz.dtype))
    return feat, qz.stats


def fast_i3d_features_q(ft_model, x: torch.Tensor, act_scales: dict[str, float], *,
                        stem_int8: bool = False, use_kernel: bool = True,
                        quantizer: _Quantizer | None = None) -> torch.Tensor:
    """Quantized ``extract_features`` of the unchanged WrapperI3D: NDHWC (B, T, H, W, 3)
    clips -> (B, 2048) float32. ``quantizer``: a run-mode quantizer to reuse."""
    _check_supported(ft_model)
    qz = quantizer or _Quantizer("run", act_scales, _dtype(ft_model), use_kernel=use_kernel)
    return _q_features(qz, ft_model, x, stem_int8)


def make_quant_ft_extract(ft_model, act_scales: dict[str, float], *, stem_int8: bool = False,
                          use_kernel: bool = True):
    """Quantized drop-in for the ft's ``extract_features``: ``extract(clips)`` takes (B, 3,
    T, H, W) clips and returns (B, 2048) float32. Even spatial dims only, as the JAX
    path requires; loud errors, never a silent bf16 fallback. Weights are quantized on
    the first call and kept."""
    _check_supported(ft_model)
    qz = _Quantizer("run", act_scales, _dtype(ft_model), use_kernel=use_kernel)

    def extract(clips: torch.Tensor) -> torch.Tensor:
        if clips.shape[-1] % 2 or clips.shape[-2] % 2:
            raise ValueError(f"quantized ft needs even spatial dims, got "
                             f"{clips.shape[-2]}x{clips.shape[-1]}")
        return fast_i3d_features_q(ft_model, clips.permute(0, 2, 3, 4, 1), act_scales,
                                   stem_int8=stem_int8, quantizer=qz)

    return extract
