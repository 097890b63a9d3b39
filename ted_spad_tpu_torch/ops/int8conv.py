"""int8 x int8 -> int32 convolution with the W8A8 dequant epilogue (the convolution
of ``_Quantizer.conv`` in ted_spad_tpu/ops/quant_unetpp.py:125-144, which XLA runs as
``conv_general_dilated(int8, int8) -> int32``).

    out = (float32(sum of int8 products) * (act_scale * w_scale[c])).to(out_dtype)

- ``int8_conv_int32``: the plain int32 sums. The int8 codes are convolved as float64
  (``F.conv2d`` / ``F.conv3d``), which is exact: a sum reaches about
  127^2 * 9 * 512 = 7.4e7 in the UNet++ and up to 127^2 * 3 * 2048 in I3Res50, above
  float32's 2^24 but far below float64's 2^53.
- ``int8_conv_reference``: the plain version, those sums through the epilogue.
- ``int8_conv``: the kernel wrapper (K4, csrc/int8conv.cu). On a CUDA tensor it
  launches the hand-written implicit-GEMM kernel, or with ``use_kernel=False`` runs the
  plain version; on a CPU tensor it runs the plain version. Its ``launches`` attribute
  counts kernel launches.
- ``Int8Weight`` / ``int8_weight``: a weight quantized once (codes and per-Cout scales
  from ``quantize_weight``) with the kernel's packed layout beside it.

Layouts: activations NHWC or NDHWC int8 (a 2D conv is the 3D one at D = 1), kernels
HWIO / DHWIO, explicit (low, high) pads per spatial dim, strides, and ``lhs_dilation``
(the input with dilation - 1 zeros between its pixels, as XLA's ``lhs_dilation``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

K4_BK = 64  # bytes of K per stage (csrc/int8conv.cu: kBK); packed rows are multiples


class Int8Weight(NamedTuple):
    """A convolution kernel quantized per output channel."""
    codes: torch.Tensor  # (..., Cin, Cout) int8, HWIO / DHWIO
    scale: torch.Tensor  # (Cout,) float32
    packed: torch.Tensor  # (Cout, Kpad) int8: K = tap * Cin32 + c, zero past Cin and K

    @property
    def taps(self) -> tuple[int, ...]:
        return tuple(self.codes.shape[:-2])


def weight_qscale(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric int8 scale for a (..., Cout) kernel."""
    a = w.abs().amax(dim=tuple(range(w.dim() - 1)))
    return torch.clamp(a, min=1e-8) / 127.0


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(kernel) -> (int8 kernel, per-Cout float32 scale), rounding to nearest even."""
    w = w.float()
    s = weight_qscale(w)
    return torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), s


def pack_weight(codes: torch.Tensor) -> torch.Tensor:
    """(..., Cin, Cout) int8 codes -> (Cout, Kpad) int8 rows as K4 reads them: K index
    tap * Cin32 + c over the taps in (d, h, w) order, each tap's Cin zero-padded to a
    multiple of 32 and the row to a multiple of K4_BK."""
    *taps, cin, cout = codes.shape
    cin32 = -(-cin // 32) * 32
    n_taps = 1
    for k in taps:
        n_taps *= k
    rows = torch.zeros((cout, n_taps, cin32), dtype=torch.int8, device=codes.device)
    rows[:, :, :cin] = codes.reshape(n_taps, cin, cout).permute(2, 0, 1)
    k = n_taps * cin32
    kpad = -(-k // K4_BK) * K4_BK
    return F.pad(rows.reshape(cout, k), (0, kpad - k)).contiguous()


def int8_weight(w: torch.Tensor) -> Int8Weight:
    """Quantize a float kernel (HWIO / DHWIO) once and pack it for K4."""
    codes, scale = quantize_weight(w)
    return Int8Weight(codes, scale, pack_weight(codes))


def _geometry(x_shape, taps, strides, padding, lhs_dilation):
    """(5D input shape, taps, strides, pads, dilation, 5D output shape) of a conv,
    2D arguments lifted to D = 1."""
    nd = len(taps)
    if len(x_shape) != nd + 2 or nd not in (2, 3):
        raise ValueError(f"int8_conv: a {nd}D kernel takes a {nd + 2}D input, got {tuple(x_shape)}")
    strides = tuple(strides) if strides is not None else (1,) * nd
    dil = tuple(lhs_dilation) if lhs_dilation is not None else (1,) * nd
    pads = tuple(tuple(p) for p in padding)
    if not (len(strides) == len(dil) == len(pads) == nd):
        raise ValueError(f"int8_conv: strides {strides}, pads {pads}, dilation {dil} for {nd}D taps")
    if any(s < 1 for s in strides + dil) or any(p < 0 for pair in pads for p in pair):
        raise ValueError(f"int8_conv: strides {strides} / dilation {dil} / pads {pads}")
    n, *spatial, cin = x_shape
    out = [((s - 1) * d + 1 + lo + hi - k) // st + 1
           for s, d, (lo, hi), k, st in zip(spatial, dil, pads, taps, strides)]
    if any(o < 1 for o in out):
        raise ValueError(f"int8_conv: empty output {out} for input {tuple(x_shape)}")
    if nd == 2:
        lift = lambda t, v: (v,) + tuple(t)  # noqa: E731
        return ((n, 1, *spatial, cin), lift(taps, 1), lift(strides, 1),
                ((0, 0),) + pads, lift(dil, 1), (n, 1, *out))
    return (tuple(x_shape), tuple(taps), strides, pads, dil, (n, *out))


def int8_conv_int32(x: torch.Tensor, codes: torch.Tensor, *, strides=None, padding,
                    lhs_dilation=None) -> torch.Tensor:
    """The plain int32 sums of an int8 conv: (N, [D,] H, W, Cin) int8 with codes
    ([KD,] KH, KW, Cin, Cout) int8 -> (N, [Do,] Ho, Wo, Cout) int32, computed in float64
    (exact), on x's device."""
    nd = codes.dim() - 2
    _geometry(x.shape, codes.shape[:-2], strides, padding, lhs_dilation)
    strides = tuple(strides) if strides is not None else (1,) * nd
    xf = x.to(torch.float64).movedim(-1, 1)  # (N, Cin, *spatial)
    if lhs_dilation is not None and any(d != 1 for d in lhs_dilation):
        size = [(s - 1) * d + 1 for s, d in zip(xf.shape[2:], lhs_dilation)]
        stuffed = xf.new_zeros(xf.shape[:2] + tuple(size))
        stuffed[(slice(None), slice(None)) + tuple(slice(None, None, d) for d in lhs_dilation)] = xf
        xf = stuffed
    xf = F.pad(xf, [p for pair in reversed([tuple(p) for p in padding]) for p in pair])
    wf = codes.to(torch.float64).permute(nd + 1, nd, *range(nd))  # (Cout, Cin, *taps)
    conv = F.conv2d if nd == 2 else F.conv3d
    y = conv(xf, wf, stride=strides)
    return y.movedim(1, -1).to(torch.int32)


def epilogue(acc: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """int32 sums -> float32 -> times the per-channel float32 scale -> ``out_dtype``."""
    return (acc.to(torch.float32) * scale).to(out_dtype)


def channel_scale(act_scale: float, w_scale: torch.Tensor) -> torch.Tensor:
    """act_scale * w_scale[c] in float32, as JAX multiplies a Python float (weakly
    typed, so rounded to float32 first) by the float32 weight scales: torch rounds a
    Python scalar to the tensor's float32 too."""
    return w_scale * float(act_scale)


def int8_conv_reference(x: torch.Tensor, weight: Int8Weight, act_scale: float, *, strides=None,
                        padding, lhs_dilation=None,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of K4: ``int8_conv_int32`` through the dequant epilogue."""
    acc = int8_conv_int32(x, weight.codes, strides=strides, padding=padding,
                          lhs_dilation=lhs_dilation)
    return epilogue(acc, channel_scale(act_scale, weight.scale), out_dtype)


@functools.cache
def _library():
    from ted_spad_tpu_torch.utils.cuda_build import load

    fn = load("int8conv").ted_int8_conv
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.restype = i
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, i, p]
    return fn


def int8_conv(x: torch.Tensor, weight: Int8Weight, act_scale: float, *,
              strides: Sequence[int] | None = None, padding,
              lhs_dilation: Sequence[int] | None = None,
              out_dtype: torch.dtype = torch.bfloat16, use_kernel: bool = True) -> torch.Tensor:
    """One W8A8 convolution: int8 activations ``x`` (N, [D,] H, W, Cin) with scale
    ``act_scale`` and ``weight`` -> (N, [Do,] Ho, Wo, Cout) ``out_dtype`` (bfloat16 or
    float32), contiguous. ``padding``: (low, high) per spatial dim.

    On CUDA with ``use_kernel`` this launches kernel K4 on the current stream (x must
    be contiguous); otherwise, and on the CPU, it runs ``int8_conv_reference``."""
    if x.dtype != torch.int8 or weight.codes.dtype != torch.int8:
        raise ValueError(f"int8_conv takes int8 activations and codes, got {x.dtype} / "
                         f"{weight.codes.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise ValueError(f"int8_conv writes float32 or bfloat16 (float64 in its plain version), "
                         f"not {out_dtype}")
    shape5, taps, strides5, pads5, dil5, out5 = _geometry(
        x.shape, weight.taps, strides, padding, lhs_dilation)
    cin, cout = weight.codes.shape[-2:]
    if x.shape[-1] != cin:
        raise ValueError(f"int8_conv: input has {x.shape[-1]} channels, the kernel {cin}")
    if x.device.type == "cpu" or (x.device.type == "cuda" and not use_kernel):
        return int8_conv_reference(x, weight, act_scale, strides=strides, padding=padding,
                                   lhs_dilation=lhs_dilation, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv runs on cuda or cpu, not {x.device}")
    if out_dtype == torch.float64:
        raise ValueError("int8_conv's kernel writes float32 or bfloat16, not float64")
    if weight.packed.device != x.device:
        raise ValueError(f"int8_conv: weight on {weight.packed.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("int8_conv needs contiguous (N, [D,] H, W, C) activations")
    if cin % 16 == 0 and x.data_ptr() % 16:
        raise ValueError("int8_conv: x must start on a 16-byte boundary (read 16 bytes at a time)")
    scale = channel_scale(act_scale, weight.scale)
    out_shape = out5[:1] + (out5[1:] if x.dim() == 5 else out5[2:]) + (cout,)
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    geom = (ctypes.c_int * 15)(*taps, *strides5, *(lo for lo, _ in pads5), *dil5, *out5[1:])
    n, d, h, w, _ = shape5
    with torch.cuda.device(x.device):
        err = _library()(x.data_ptr(), weight.packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
                         int(out_dtype == torch.bfloat16), n, d, h, w, cin, cout, geom,
                         weight.packed.shape[1], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_conv: kernel launch failed with cudaError {err}")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
