"""Bilinear upsampling (align_corners=True) whose gradient repeats bit for bit on the
card (kernel K6).

The plain UNet's decoder doubles its maps with ``resize_bilinear`` (models/layers.py;
JAX: ted_spad_tpu/models/layers.py:109, explicit gather weights in XLA, whose gradient
gives the same bits on every run). Torch's CUDA backward of ``F.interpolate(mode=
"bilinear")`` adds each output's four taps into the input with atomics, so a training
step through the plain UNet does not repeat.

- ``upsample_bilinear``: ``F.interpolate(x, SCALE x size, "bilinear",
  align_corners=True)`` over (N, C, H, W). Under grad, for an input that requires grad,
  an autograd Function whose backward is ``upsample_bilinear_backward``; otherwise the
  plain ``F.interpolate``, so serving is unchanged.
- ``upsample_bilinear_backward``: the kernel wrapper (K6, csrc/upsample_bilinear.cu).
  On a CUDA tensor it launches the hand-written gather kernel (no fallback) with the
  mapping ``k6_plan`` picks; on a CPU tensor it runs the plain version. Its
  ``launches`` attribute counts kernel launches.
- ``k6_plan``: the kernel's launch. A block owns a band of ``K6_BAND`` input rows of
  one plane (n, c_outer) x a run of columns; its threads take (channel vector, column)
  pairs and walk the band's output rows once, the vector 16 bytes of channels where
  the layout allows, one element elsewhere.
- ``upsample_bilinear_backward_reference``: the plain version, the separable sum
  grad_in[iy, ix] = sum_oy wy * (sum_ox wx * g[oy, ox]) with each axis's outputs in
  ascending order, written as masked dense products over the 4 x SCALE candidate
  offsets of each axis (``axis_taps``). The kernel sums the same products in the same
  order, each rounded on its own, so the two are bit-equal.

The taps are torch's forward's: scale = (in - 1) / (out - 1) and src = scale * o in the
data's type, i0 = (int)src, i1 = i0 + (i0 < in - 1), lam = src - i0; output o reads
input i with weight (i0 == i ? 1 - lam : 0) + (i1 == i ? lam : 0).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ted_spad_tpu_torch.ops.maxpool3d import sample_span, thread_block, vector_width, vectors_fit

_DTYPES = {torch.float32: 0, torch.float64: 2}
SCALE = 2  # the factor of both axes: the UNet's decoder doubles its maps, and K6 takes only this
K6_BAND = 16  # input rows a K6 block owns at most (csrc/upsample_bilinear.cu: kMaxBand, 32)
K6_LANES = 16  # channel vectors a K6 block takes
K6_MIN_BLOCKS = 132 * 8  # a grid below this halves the band, down to 4 rows


class K6Plan(NamedTuple):
    vec: int  # channels a thread takes at once
    channels_last: bool
    block: tuple[int, int]  # (channel vectors, columns)
    band: int  # input rows a block
    grid: tuple[int, int, int]  # (planes x bands, column chunks, channel-vector chunks)
    fits: bool  # samples below 2^31 elements, the grid below (2^31, 2^16, 2^16)


def k6_plan(grad_out: torch.Tensor, input_shape, channels_last: bool) -> K6Plan:
    """``_k6_plan`` for these operands (cached on their shape, strides and alignment: the
    plan is host time on every backward)."""
    return _k6_plan(tuple(int(s) for s in input_shape), grad_out.dtype, tuple(grad_out.shape), grad_out.stride(),
                    channels_last, vectors_fit(grad_out, vector_width(grad_out.dtype)))


@functools.lru_cache(maxsize=1024)
def _k6_plan(input_shape: tuple, dtype: torch.dtype, out_shape: tuple, go_stride: tuple, channels_last: bool,
             vectors: bool) -> K6Plan:
    """K6's launch for these operands (csrc/upsample_bilinear.cu): planes (n) of H x W x
    C elements in channels_last, (n, c) of H x W in NCHW, cut into bands of ``K6_BAND``
    input rows; 16-byte vectors of channels where ``grad_in`` is channels_last, C a
    multiple of the vector width and grad_out holds such vectors (``vectors_fit``), else
    one element a thread (the generic path). A block takes up to K6_LANES vectors of a
    run of columns; the band halves, down to 4 rows, while the grid holds fewer than
    K6_MIN_BLOCKS blocks."""
    n, c, h, w = input_shape
    width = vector_width(dtype)
    vec = width if channels_last and c % width == 0 and vectors else 1
    c_outer, c_inner = (1, c) if channels_last else (c, 1)
    bx, by, _ = thread_block(min(c_inner // vec, K6_LANES), w, 1, 1)
    band = K6_BAND
    grid = lambda band: (n * c_outer * -(-h // band), -(-w // by), -(-(c_inner // vec) // bx))  # noqa: E731
    while band > 4 and math.prod(grid(band)) < K6_MIN_BLOCKS:
        band //= 2
    fits = (max(sample_span(out_shape, go_stride), math.prod(input_shape[1:])) < 2 ** 31
            and grid(band)[0] < 2 ** 31 and max(grid(band)[1:]) < 2 ** 16)
    return K6Plan(vec, channels_last, (bx, by), band, grid(band), fits)


def is_channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` (N, C, H, W) lies in channels_last memory (and not also in the
    contiguous layout)."""
    return x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)


def axis_taps(n_in: int, dtype: torch.dtype, device) -> list[tuple]:
    """The outputs that read each input along one axis of ``n_in`` inputs and
    ``SCALE * n_in`` outputs: for each candidate offset j in [-SCALE - 1, 3 SCALE - 2],
    ascending, (output index o = SCALE * i + j clamped into range (n_in,), whether o
    reads i (n_in,) bool, its weight there (n_in,) in ``dtype``)."""
    n_out = n_in * SCALE
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    # (in - 1) / (out - 1) rounded once in the data's type, as torch's forward takes it.
    step = float(np_dtype(n_in - 1) / np_dtype(n_out - 1)) if n_out > 1 else 0.0
    i = torch.arange(n_in, device=device)
    taps = []
    for j in range(-SCALE - 1, 3 * SCALE - 1):
        o = SCALE * i + j
        src = o.to(dtype) * step
        i0 = src.to(torch.int64)  # truncation, as the kernel's (int) cast
        i1 = i0 + (i0 < n_in - 1).to(torch.int64)
        lam1 = src - i0.to(dtype)
        lam0 = 1 - lam1
        hit0, hit1 = i0 == i, i1 == i
        reads = (o >= 0) & (o < n_out) & (hit0 | hit1)
        weight = torch.where(hit0, lam0, 0.0) + torch.where(hit1, lam1, 0.0)
        taps.append((o.clamp(0, n_out - 1), reads, weight))
    return taps


def upsample_bilinear_backward_reference(grad_out: torch.Tensor, input_shape,
                                         channels_last: bool = False) -> torch.Tensor:
    """Plain version: ``grad_in`` (``input_shape``, grad_out's dtype, channels_last
    memory with ``channels_last``) of ``upsample_bilinear``."""
    n, c, h, w = (int(s) for s in input_shape)
    dtype, dev = grad_out.dtype, grad_out.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    t = torch.zeros((n, c, grad_out.shape[2], w), dtype=dtype, device=dev)
    for o, reads, weight in axis_taps(w, dtype, dev):
        t = t + torch.where(reads, weight * grad_out.index_select(3, o), zero)
    acc = torch.zeros((n, c, h, w), dtype=dtype, device=dev)
    for o, reads, weight in axis_taps(h, dtype, dev):
        acc = acc + torch.where(reads[:, None], weight[:, None] * t.index_select(2, o), zero)
    return acc.contiguous(memory_format=torch.channels_last if channels_last else torch.contiguous_format)


@functools.cache
def _library():
    from ted_spad_tpu_torch.utils.cuda_build import load

    fn = load("upsample_bilinear").ted_upsample_bilinear_backward
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.restype = i
    fn.argtypes = [p, p, i, p, p, p, p]
    return fn


def upsample_bilinear_backward(grad_out: torch.Tensor, input_shape, channels_last: bool = False) -> torch.Tensor:
    """``grad_in`` of ``upsample_bilinear`` (see the reference): kernel K6 on a CUDA
    tensor (``launches`` counts it), the plain version on a CPU tensor. grad_out
    (N, C, SCALE H, SCALE W) float32 or float64, any layout."""
    input_shape = tuple(int(s) for s in input_shape)
    if (grad_out.dim() != 4 or len(input_shape) != 4
            or tuple(grad_out.shape) != input_shape[:2] + (input_shape[2] * SCALE, input_shape[3] * SCALE)):
        raise ValueError(f"upsample_bilinear_backward: grad_out {tuple(grad_out.shape)} is not the "
                         f"x{SCALE} upsample of {input_shape}")
    if grad_out.dtype not in _DTYPES:
        raise ValueError(f"upsample_bilinear_backward takes float32 or float64, not {grad_out.dtype}")
    if grad_out.device.type == "cpu":
        return upsample_bilinear_backward_reference(grad_out, input_shape, channels_last)
    if grad_out.device.type != "cuda":
        raise ValueError(f"upsample_bilinear_backward runs on cuda or cpu, not {grad_out.device}")
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    grad_in = torch.empty(input_shape, dtype=grad_out.dtype, device=grad_out.device, memory_format=fmt)
    if grad_in.numel() == 0:
        return grad_in
    plan = k6_plan(grad_out, input_shape, channels_last)
    if not plan.fits:
        raise ValueError(f"upsample_bilinear_backward: K6 takes samples below 2^31 elements and grids "
                         f"below (2^31, 2^16) blocks, not {input_shape} (grid {plan.grid})")
    with torch.cuda.device(grad_out.device):
        err = _library()(grad_out.data_ptr(), grad_in.data_ptr(), _DTYPES[grad_out.dtype],
                         (ctypes.c_int * 4)(*input_shape),
                         (ctypes.c_longlong * 4)(*grad_out.stride()),
                         (ctypes.c_int * 5)(plan.vec, int(channels_last), *plan.block, plan.band),
                         torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"upsample_bilinear_backward: kernel launch failed with cudaError {err}")
    upsample_bilinear_backward.launches += 1
    return grad_in


upsample_bilinear_backward.launches = 0


def _upsample(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=(x.shape[2] * SCALE, x.shape[3] * SCALE), mode="bilinear", align_corners=True)


class _UpsampleBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.meta = (tuple(x.shape), is_channels_last(x))
        return _upsample(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        shape, channels_last = ctx.meta
        return upsample_bilinear_backward(grad_out, shape, channels_last)


def upsample_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear upsample of (N, C, H, W) by SCALE, align_corners=True, in ``x``'s dtype
    (float32 or float64 under grad); keeps the memory format. Under grad, for an ``x``
    that requires grad, its gradient comes from ``upsample_bilinear_backward`` (K6 on
    the card)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _UpsampleBilinear.apply(x)
    return _upsample(x)
