"""W8A8 post-training quantization of the UNet++ eval path for serving (counterpart of
ted_spad_tpu/ops/quant_unetpp.py, with its site names letter for letter, so one
``{site: scale}`` dict serves both packages).

Scheme (standard post-training W8A8, no retraining):
- Weights: per-output-channel symmetric int8, scale = absmax / 127, from the module's
  unchanged weights (re-binned up2 kernels quantized after re-binning). fa and ft are
  frozen, so a built apply quantizes each weight once, on its first call, and keeps it
  (with K4's packed layout) for every later batch.
- Activations: per-tensor symmetric int8 with scales from a calibration pass
  (``calibrate_unetpp``: the same schedule in the compute dtype, recording each site's
  absmax) over the run's leading batches.
- Convolutions: int8 x int8 -> int32 through kernel K4 on the card
  (ops/int8conv.py), dequantized by the per-channel ``act_scale * w_scale`` epilogue;
  the folded BatchNorm, ReLU and the requantization at the next site are torch
  elementwise ops. The stem (Cin 3), the up2 convolutions (on the dequantized input,
  unless ``up2_int8``) and the head stay in the compute dtype.

Calibration and run mode execute the same forward (``_qforward``), so the sites
recorded and the sites consumed cannot drift; both reuse ``fast_unetpp._decoder_schedule``
through its plug points. Layout NHWC; the apply built by ``make_quant_fa_apply`` takes
and returns the module's NCHW frames.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ted_spad_tpu_torch.ops import int8conv
from ted_spad_tpu_torch.ops.fast_unetpp import (
    _R18_ENC_LAYERS, _apply_head, _bn_affine, _decoder_schedule, _pad_to, _resnet_maxpool,
    _stem_conv, conv_nhwc, encoder_layout_standard, kernel, up2_conv, up2_dilated_kernel,
)
from ted_spad_tpu_torch.ops.int8conv import quantize_weight, weight_qscale  # noqa: F401


class QT(NamedTuple):
    """A quantized activation: int8 codes and their Python-float scale (run mode), or
    the plain ``dtype`` tensor and None (calibration mode)."""
    data: torch.Tensor
    scale: float | None


def act_scales_from_absmax(stats: dict) -> dict[str, float]:
    """Calibration absmax per site -> symmetric int8 scales (clamped: an all-zero
    calibration tensor must not give a 0 scale)."""
    return {k: max(float(v), 1e-6) / 127.0 for k, v in stats.items()}


class _Quantizer:
    """Mode 'run': int8 convolutions with static per-site activation scales.
    Mode 'calib': the identical schedule in ``dtype``, recording per-site absmax into
    ``self.stats``. One code path serves both, so recorded sites == consumed sites.

    ``use_kernel``: run mode's convolutions through K4 on a CUDA tensor (False: the
    plain int8 conv)."""

    def __init__(self, mode: str, act_scales: dict | None, dtype: torch.dtype, *,
                 use_kernel: bool = True):
        if mode not in ("run", "calib"):
            raise ValueError(f"quantizer mode {mode!r}")
        if mode == "run" and not act_scales:
            raise ValueError("run mode needs calibrated act_scales (calibrate_unetpp)")
        self.mode = mode
        self.act = act_scales or {}
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.stats: dict[str, torch.Tensor] = {}
        self._weights: dict[str, object] = {}  # run mode: weights by key, made once

    def cached(self, key: str, make: Callable):
        """The value ``make()`` gave the first time ``key`` was asked for."""
        if key not in self._weights:
            self._weights[key] = make()
        return self._weights[key]

    def weight(self, key: str, make: Callable) -> torch.Tensor:
        """A kernel for a convolution in ``dtype``: ``make()``, kept under ``key`` in run
        mode."""
        return make() if self.mode == "calib" else self.cached(key, make)

    def affine(self, key: str, convbn) -> tuple[torch.Tensor, torch.Tensor]:
        """``convbn``'s eval BatchNorm folded to (scale, bias) in ``dtype``, kept under
        ``key`` in run mode."""
        def make():
            sc, bi = _bn_affine(convbn.bn)
            return sc.to(self.dtype), bi.to(self.dtype)

        return self.weight(f"{key}.bn", make)

    def q8(self, site: str, x: torch.Tensor) -> QT:
        """Quantize an activation at a named site (or record its absmax)."""
        if self.mode == "calib":
            self.stats[site] = x.float().abs().amax()
            return QT(x.to(self.dtype), None)
        s = float(self.act[site])
        q = torch.clamp(torch.round(x.float() * (1.0 / s)), -127, 127).to(torch.int8)
        return QT(q.contiguous(), s)

    def dequant(self, qx: QT) -> torch.Tensor:
        if self.mode == "calib":
            return qx.data
        return (qx.data.float() * qx.scale).to(self.dtype)

    def conv(self, qx: QT, w: Callable[[], torch.Tensor], key: str, *, strides=(1, 1),
             padding=((1, 1), (1, 1)), lhs_dilation=None) -> torch.Tensor:
        """One quantized conv: int8 x int8 -> int32, dequantized per channel (K4 on the
        card). ``w``: a zero-argument callable giving the float32 HWIO / DHWIO kernel,
        quantized once under ``key``. Calib mode: the same conv in ``dtype``."""
        if self.mode == "calib":
            if lhs_dilation is not None:
                return up2_conv(qx.data, w(), self.dtype)  # the only dilated conv: up2_int8
            return conv_nhwc(qx.data, w(), strides, padding, self.dtype)
        weight = self.cached(key, lambda: int8conv.int8_weight(w()))
        return int8conv.int8_conv(qx.data, weight, qx.scale, strides=strides, padding=padding,
                                  lhs_dilation=lhs_dilation, out_dtype=self.dtype,
                                  use_kernel=self.use_kernel)

    def maxpool(self, qx: QT) -> QT:
        """The r18 stem max pool on the int8 codes (max is monotone, so pooling codes is
        pooling the dequantized values; the scale is kept). The codes are pooled as
        floats, which hold them exactly."""
        if self.mode == "calib":
            return QT(_resnet_maxpool(qx.data), None)
        return QT(_resnet_maxpool(qx.data.float()).to(torch.int8).contiguous(), qx.scale)

    def maxpool_valid(self, qx: QT, window, strides) -> QT:
        """torch MaxPool padding=0 (VALID) over the channels-last layout, any spatial
        rank; scale-preserving on int8 codes like ``maxpool``."""
        nd = len(window)
        pool = F.max_pool2d if nd == 2 else F.max_pool3d
        x = qx.data if self.mode == "calib" else qx.data.float()
        y = pool(x.movedim(-1, 1), tuple(window), tuple(strides)).movedim(1, -1)
        if self.mode == "calib":
            return QT(y, None)
        return QT(y.to(torch.int8).contiguous(), qx.scale)


def _affine_relu(y: torch.Tensor, affine: tuple[torch.Tensor, torch.Tensor], *,
                 relu: bool = True) -> torch.Tensor:
    """``y * scale + bias`` of a folded BatchNorm (``_Quantizer.affine``), then ReLU."""
    sc, bi = affine
    y = y * sc + bi
    return F.relu(y) if relu else y


def _qbasic(qz: _Quantizer, block, qx: QT, stride: int, site: str) -> torch.Tensor:
    """Quantized torchvision BasicBlock. Returns the plain pre-quantization output; the
    caller quantizes at the block's out site."""
    y = qz.conv(qx, lambda: kernel(block.conv1.conv), f"{site}.conv1", strides=(stride, stride))
    y = _affine_relu(y, qz.affine(f"{site}.conv1", block.conv1))
    yq = qz.q8(f"{site}_mid", y)
    y = qz.conv(yq, lambda: kernel(block.conv2.conv), f"{site}.conv2")
    y = _affine_relu(y, qz.affine(f"{site}.conv2", block.conv2), relu=False)
    if block.downsample is not None:
        r = qz.conv(qx, lambda: kernel(block.downsample.conv), f"{site}.downsample",
                    strides=(stride, stride), padding=((0, 0), (0, 0)))
        r = _affine_relu(r, qz.affine(f"{site}.downsample", block.downsample), relu=False)
    else:
        # Exact residual: the int8 code times its scale is the value the net saw.
        r = qz.dequant(qx)
    return F.relu(y + r)


# Encoder block whose output is a decoder skip feature: its out site is the decoder's
# f-name, so the tensor is quantized once with one scale.
_F_ALIAS = {("layer1", 1): "f2", ("layer2", 1): "f1", ("layer3", 1): "f0"}


def _qencoder(qz: _Quantizer, encoder, frames: torch.Tensor) -> list[QT]:
    """Quantized ResNet-18 encoder. The stem (Cin 3) stays in ``dtype``; its ReLU output
    is quantized once at site 'f3' (layer1's input through the int8 max pool, and the
    decoder's /2 skip). Returns the decoder's f list [f0 (/16), f1 (/8), f2 (/4),
    f3 (/2)] as QTs."""
    y = _stem_conv(encoder.stem, frames, qz.dtype,
                   qz.weight("stem", lambda: kernel(encoder.stem.conv).to(qz.dtype)))
    f1 = _affine_relu(y, qz.affine("stem", encoder.stem))
    f3 = qz.q8("f3", f1)
    x = qz.maxpool(f3)
    feats = [f3]
    for lname, nblocks, stride in _R18_ENC_LAYERS:
        for i in range(nblocks):
            site = f"enc_{lname}_{i}"
            z = _qbasic(qz, getattr(encoder, f"{lname}_{i}"), x, stride if i == 0 else 1, site)
            x = qz.q8(_F_ALIAS.get((lname, i), f"{site}_out"), z)
        feats.append(x)
    return feats[::-1]


def _qdecoder(qz: _Quantizer, model, f: list, up2_int8: bool = False) -> torch.Tensor:
    """The quantized nested-skip decoder over the f list of QTs. Returns x_0_3 (plain
    ``dtype``, pre-head)."""

    def blk(name: str, xin: QT, skip_sum):
        block = getattr(model, name)
        cx = xin.data.shape[-1]

        def w44():
            # Quantize the re-binned (4, 4) kernel: the tap algebra stays exact in f32.
            return up2_dilated_kernel(kernel(block.conv1.conv)[:, :, :cx, :])

        if up2_int8:
            y = qz.conv(xin, w44, f"{name}.up2", padding=((2, 2), (2, 2)), lhs_dilation=(2, 2))
        else:
            # The up2 convs run in ``dtype`` on the dequantized input (the JAX package's
            # default: its lhs-dilated form gained nothing from int8 on its chip).
            y = up2_conv(qz.dequant(xin), qz.weight(f"{name}.up2", lambda: w44().to(qz.dtype)),
                         qz.dtype)
        if skip_sum is not None:
            y = _pad_to(y, skip_sum.shape) + skip_sum
        y = _affine_relu(y, qz.affine(f"{name}.conv1", block.conv1))
        yq = qz.q8(f"{name}_mid", y)
        z = qz.conv(yq, lambda: kernel(block.conv2.conv), f"{name}.conv2")
        if block.conv2.conv.bias is not None:
            z = z + block.conv2.conv.bias.to(z.dtype)
        z = _affine_relu(z, qz.affine(f"{name}.conv2", block.conv2))
        if name == "x_0_3":
            return z  # feeds the head in ``dtype``: never quantized
        return qz.q8(f"{name}_out", z)

    def conv(site: str, qx: QT, w) -> torch.Tensor:
        return qz.conv(qx, w, site)

    return _decoder_schedule(model, f, qz.dtype, blk, conv=conv)


def _qforward(qz: _Quantizer, model, frames: torch.Tensor, up2_int8: bool = False) -> torch.Tensor:
    in_h, in_w = frames.shape[-3], frames.shape[-2]
    f = _qencoder(qz, model.encoder, frames)
    x_0_3 = _qdecoder(qz, model, f, up2_int8)
    return _apply_head(model.head, x_0_3, in_h, in_w, qz.dtype,
                       qz.weight("head", lambda: kernel(model.head).to(qz.dtype)))


def _dtype(model) -> torch.dtype:
    return model.head.weight.dtype


def calibrate_unetpp(model, frames: torch.Tensor, *, dtype: torch.dtype | None = None):
    """Calibration pass: the quantization schedule in ``dtype`` (default: the module's)
    over NHWC ``frames``, returning ``(out (N, H, W, 3) float32, {site: absmax})``. Run
    it over representative batches, max-reduce across batches, then
    ``act_scales_from_absmax``."""
    qz = _Quantizer("calib", None, dtype or _dtype(model))
    out = _qforward(qz, model, frames)
    return out, qz.stats


def fast_unetpp_apply_q(model, frames: torch.Tensor, act_scales: dict[str, float], *,
                        dtype: torch.dtype | None = None, up2_int8: bool = False,
                        use_kernel: bool = True, quantizer: _Quantizer | None = None):
    """Quantized eval forward of the unchanged UNetPlusPlus: NHWC frames -> (N, H, W, 3)
    float32. ``act_scales``: per-site scales (``calibrate_unetpp`` +
    ``act_scales_from_absmax``, or the JAX package's). ``quantizer``: a run-mode
    quantizer to reuse (its weights are kept between calls)."""
    qz = quantizer or _Quantizer("run", act_scales, dtype or _dtype(model), use_kernel=use_kernel)
    return _qforward(qz, model, frames, up2_int8)


def check_quant_fa(fa_model) -> None:
    """Raise ValueError unless ``fa_model`` is the standard UNet++ (ResNet-18 encoder,
    decoder (256, 128, 64, 32)) that the int8 path is derived for."""
    from ted_spad_tpu_torch.models.unet import UNetPlusPlus

    if not (isinstance(fa_model, UNetPlusPlus)
            and tuple(getattr(fa_model, n).conv2.conv.out_channels
                      for n in ("x_0_0", "x_0_1", "x_0_2", "x_0_3")) == (256, 128, 64, 32)
            and encoder_layout_standard(fa_model.encoder)):
        raise ValueError("quant='int8' supports the standard UNet++ (r18 encoder, decoder "
                         "(256,128,64,32)) eval path only")


def make_quant_fa_apply(fa_model, act_scales: dict[str, float], *, up2_int8: bool = False,
                        use_kernel: bool = True):
    """Quantized drop-in for the fa module's eval forward: ``apply(frames)`` takes (N, 3,
    H, W) frames (channels_last) and returns (N, 3, H, W) float32 (an NCHW view of NHWC
    memory). Requires the standard UNet++ (``check_quant_fa``): anything else raises,
    since a silent bf16 fallback would misreport what an int8 run measured. Weights are
    quantized on the first call and kept."""
    check_quant_fa(fa_model)
    qz = _Quantizer("run", act_scales, _dtype(fa_model), use_kernel=use_kernel)

    def apply(frames: torch.Tensor) -> torch.Tensor:
        h, w = frames.shape[-2], frames.shape[-1]
        if h % 16 or w % 16:
            raise ValueError(f"quantized fa needs 16-aligned spatial dims, got {h}x{w}")
        out = fast_unetpp_apply_q(fa_model, frames.permute(0, 2, 3, 1), act_scales,
                                  up2_int8=up2_int8, quantizer=qz)
        return out.permute(0, 3, 1, 2)

    return apply
