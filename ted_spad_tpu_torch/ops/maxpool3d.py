"""3D max pooling whose gradient repeats bit for bit on the card (kernel K5).

The JAX package pools through XLA's ``reduce_window`` (flax ``nn.max_pool``:
ted_spad_tpu/models/layers.py:84-100, ted_spad_tpu/models/mvit.py:151) and takes its
gradient through ``select_and_scatter``: the same bits on every run. Torch's CUDA
backward of ``F.max_pool3d`` adds overlapping windows' gradients with atomics, so a
training step through an overlapping pool (the I3Res50's stem pool, InceptionI3d's
SAME pools, MViTv2's skip pools) does not repeat.

- ``max_pool3d``: the pool every 3D site of the port calls. Under grad, for an input
  that requires grad, it is an autograd Function: the forward is
  ``F.max_pool3d(return_indices=True)`` (XLA's ``reduce_window`` in the JAX package, no
  Pallas kernel) and the backward ``max_pool3d_backward``. Otherwise it is the plain
  ``F.max_pool3d``, so the serving paths keep their exact ops.
- ``max_pool3d_backward``: the kernel wrapper (K5, csrc/maxpool3d.cu). On a CUDA tensor
  it launches the hand-written gather kernel (no fallback: a build or launch failure
  raises); on a CPU tensor it runs the plain version. Its ``launches`` attribute counts
  kernel launches.
- ``max_pool3d_backward_reference``: the plain version. For each offset of the window,
  in descending (kd, kh, kw) order, it adds the masked strided slice of ``grad_out``
  whose argmax names that position into ``grad_in``: dense adds, no ``scatter_add``.
  Each input element so receives its windows' gradients in ascending (od, oh, ow)
  order, the kernel's order, and the two are bit-equal.

Both sum float64 in float64, float32 and bfloat16 in float32 with one rounding at the
end, and return ``grad_in`` in the input's memory format (NCDHW or channels_last_3d).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def _triple(v: int | Sequence[int]) -> tuple[int, int, int]:
    return (int(v),) * 3 if isinstance(v, int) else tuple(int(x) for x in v)


def is_channels_last_3d(x: torch.Tensor) -> bool:
    """Whether ``x`` (B, C, D, H, W) lies in channels_last_3d memory (and not also in
    the contiguous layout, as tensors with one channel or one voxel do)."""
    return (x.dim() == 5 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last_3d))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def max_pool3d_backward_reference(grad_out: torch.Tensor, indices: torch.Tensor,
                                  input_shape: Sequence[int], window: Sequence[int],
                                  strides: Sequence[int], padding: Sequence[int] = (0, 0, 0),
                                  channels_last: bool = False) -> torch.Tensor:
    """Plain version: ``grad_in`` (``input_shape``, grad_out's dtype, channels_last_3d
    memory with ``channels_last``) of a max pool over (D, H, W) whose argmax flat
    indices within the unpadded volume are ``indices`` (as ``F.max_pool3d(...,
    return_indices=True)`` gives them)."""
    b, c, d, h, w = input_shape
    kd, kh, kw = window
    sd, sh, sw = strides
    pd, ph, pw = padding
    od, oh, ow = grad_out.shape[2:]
    dev = grad_out.device
    fmt = torch.channels_last_3d if channels_last else torch.contiguous_format
    acc = torch.empty((b, c, d + 2 * pd, h + 2 * ph, w + 2 * pw), dtype=_acc_dtype(grad_out.dtype),
                      device=dev, memory_format=fmt).zero_()
    g = grad_out.to(acc.dtype)
    zero = torch.zeros((), dtype=acc.dtype, device=dev)
    grid = [torch.arange(n, device=dev) * s for n, s in ((od, sd), (oh, sh), (ow, sw))]
    for a in reversed(range(kd)):
        for e in reversed(range(kh)):
            for f in reversed(range(kw)):
                zd, zh, zw = grid[0] + (a - pd), grid[1] + (e - ph), grid[2] + (f - pw)
                inside = (((zd >= 0) & (zd < d))[:, None, None] & ((zh >= 0) & (zh < h))[None, :, None]
                          & ((zw >= 0) & (zw < w))[None, None, :])
                flat = (zd[:, None, None] * h + zh[None, :, None]) * w + zw[None, None, :]
                flat = torch.where(inside, flat, -1)  # a padded position is no element
                acc[:, :, a:a + sd * (od - 1) + 1:sd, e:e + sh * (oh - 1) + 1:sh,
                    f:f + sw * (ow - 1) + 1:sw].add_(torch.where(indices == flat, g, zero))
    out = acc[:, :, pd:pd + d, ph:ph + h, pw:pw + w]
    return out.to(grad_out.dtype).contiguous(memory_format=fmt)


@functools.cache
def _library():
    from ted_spad_tpu_torch.utils.cuda_build import load

    fn = load("maxpool3d").ted_maxpool3d_backward
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.restype = i
    fn.argtypes = [p, p, p, i, p, p, p, p, p, p, i, p]
    return fn


def _ints(ctype, values):
    return (ctype * len(values))(*values)


def max_pool3d_backward(grad_out: torch.Tensor, indices: torch.Tensor, input_shape: Sequence[int],
                        window: Sequence[int], strides: Sequence[int],
                        padding: Sequence[int] = (0, 0, 0), channels_last: bool = False) -> torch.Tensor:
    """``grad_in`` of a 3D max pool (see ``max_pool3d_backward_reference``): kernel K5 on
    a CUDA tensor (``launches`` counts it), the plain version on a CPU tensor.
    grad_out (B, C, Do, Ho, Wo) float32, bfloat16 or float64 in any layout; indices
    int64 of its shape; dilation 1."""
    window, strides, padding = _triple(window), _triple(strides), _triple(padding)
    input_shape = tuple(int(s) for s in input_shape)
    if grad_out.dim() != 5 or len(input_shape) != 5:
        raise ValueError(f"max_pool3d_backward takes 5-D grad_out and input shapes, got "
                         f"{tuple(grad_out.shape)} and {input_shape}")
    if indices.shape != grad_out.shape or indices.dtype != torch.int64 or indices.device != grad_out.device:
        raise ValueError(f"max_pool3d_backward: indices {tuple(indices.shape)} {indices.dtype} on "
                         f"{indices.device} must be int64 of grad_out's shape {tuple(grad_out.shape)} "
                         f"on {grad_out.device}")
    if grad_out.dtype not in _DTYPES:
        raise ValueError(f"max_pool3d_backward takes float32, bfloat16 or float64, not {grad_out.dtype}")
    if grad_out.device.type == "cpu":
        return max_pool3d_backward_reference(grad_out, indices, input_shape, window, strides, padding,
                                             channels_last)
    if grad_out.device.type != "cuda":
        raise ValueError(f"max_pool3d_backward runs on cuda or cpu, not {grad_out.device}")
    if max(input_shape[2:] + tuple(grad_out.shape[2:])) >= 2 ** 31 or min(strides) < 1:
        raise ValueError(f"max_pool3d_backward: sizes {input_shape} / strides {strides} out of range")
    fmt = torch.channels_last_3d if channels_last else torch.contiguous_format
    grad_in = torch.empty(input_shape, dtype=grad_out.dtype, device=grad_out.device, memory_format=fmt)
    shape = _ints(ctypes.c_int, input_shape + tuple(grad_out.shape[2:]))
    with torch.cuda.device(grad_out.device):
        err = _library()(grad_out.data_ptr(), indices.data_ptr(), grad_in.data_ptr(),
                         _DTYPES[grad_out.dtype], shape, _ints(ctypes.c_int, window),
                         _ints(ctypes.c_int, strides), _ints(ctypes.c_int, padding),
                         _ints(ctypes.c_longlong, grad_out.stride()),
                         _ints(ctypes.c_longlong, indices.stride()), int(channels_last),
                         torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"max_pool3d_backward: kernel launch failed with cudaError {err}")
    max_pool3d_backward.launches += 1
    return grad_in


max_pool3d_backward.launches = 0


class _MaxPool3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, strides, padding):
        out, indices = F.max_pool3d(x, window, strides, padding, return_indices=True)
        ctx.save_for_backward(indices)
        ctx.meta = (tuple(x.shape), window, strides, padding, is_channels_last_3d(x))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        (indices,) = ctx.saved_tensors
        shape, window, strides, padding, channels_last = ctx.meta
        return (max_pool3d_backward(grad_out, indices, shape, window, strides, padding, channels_last),
                None, None, None)


def max_pool3d(x: torch.Tensor, window: Sequence[int], strides: Sequence[int],
               padding: int | Sequence[int] = 0) -> torch.Tensor:
    """``F.max_pool3d(x, window, strides, padding)`` (floor mode, dilation 1, the
    implicit padding -inf) over (B, C, D, H, W); under grad, for an ``x`` that requires
    grad, its gradient comes from ``max_pool3d_backward`` (K5 on the card)."""
    window, strides, padding = _triple(window), _triple(strides), _triple(padding)
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool3d.apply(x, window, strides, padding)
    return F.max_pool3d(x, window, strides, padding)
