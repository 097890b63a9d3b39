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
  raises) with the mapping ``k5_plan`` picks from the operands' layouts; on a CPU
  tensor it runs the plain version. Its ``launches`` attribute counts kernel launches.
- ``k5_plan``: the kernel's launch, in one of two forms. The owner form (channels_last_3d
  with channel-stride-1 operands, windows overlapping in h or w but not in d: the stem's
  and InceptionI3d's 2a / 3a pools): a thread owns one channel of a run
  of columns of a block's input rows and walks the outputs that cover them, adding each
  output's gradient to the element its argmax names. The row form (everything else): a
  block holds input rows (b, c_outer, d, h) of the dense ``grad_in``, a thread a
  (channel vector, column w) pair gathering its windows, the vector 16 bytes of
  channels where the layout allows, one element elsewhere.
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
import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
THREADS = 256  # at most, a block
MAX_ROWS = 64  # rows a block: blockDim.z's limit
K5_CHUNK = 32  # channels an owner-form block
SUM_BYTES = 48 * 1024  # an owner-form block's sums in shared memory at most (3 blocks an SM: 144 KB)
OWNER_VISITS = 64  # outputs an owner-form thread walks, at most where one row allows


def vector_width(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in a 16-byte vector: 8 bf16, 4 float32, 2 float64."""
    return 16 // dtype.itemsize


def vectors_fit(t: torch.Tensor, width: int) -> bool:
    """Whether every ``width``-element run of ``t``'s channels (dim 1) from a channel
    multiple of ``width`` is one aligned 16-byte vector: channel stride 1, every other
    stride (of a dim longer than 1) a multiple of ``width``, the data 16-byte aligned."""
    shape, strides = t.shape, t.stride()
    return (strides[1] == 1 and t.data_ptr() % 16 == 0
            and all(s % width == 0 or n == 1 for n, s in zip(shape[:1] + shape[2:], strides[:1] + strides[2:])))


def sample_span(shape: Sequence[int], strides: Sequence[int]) -> int:
    """Elements from the first of one sample (dim 0) to its last, through ``strides``:
    the kernels address within a sample in 32 bits."""
    return 1 + sum((n - 1) * s for n, s in zip(shape[1:], strides[1:]))


def thread_block(lanes: int, columns: int, rows: int, max_rows: int) -> tuple[int, int, int]:
    """A block (x, y, z) of at most THREADS threads: x over ``lanes`` (a loop past
    THREADS), y over ``columns`` in the fewest even chunks, z over ``rows``."""
    bx = min(lanes, THREADS)
    by = min(columns, THREADS // bx)
    by = -(-columns // -(-columns // by))
    return bx, by, max(1, min(rows, THREADS // (bx * by), max_rows))


class K5Plan(NamedTuple):
    vec: int  # channels a thread stores at once
    channels_last: bool
    block: tuple[int, int, int]  # row form: (channel vectors, columns w, rows); owner form: (channels, column runs, 1)
    grid: tuple[int, int]  # row form: (row groups, column chunks); owner form: (b x d x tiles, chunks)
    owner: tuple[int, int, int]  # owner form: (input rows a block, channels a chunk, columns a thread); else 0s
    fits: bool  # samples below 2^31 elements, rows below 2^31, column chunks below 2^16


@functools.lru_cache(maxsize=1024)
def k5_owner(h: int, w: int, c: int, acc_size: int, window: tuple[int, int, int],
             strides: tuple[int, int, int]) -> tuple[int, int, int]:
    """The owner form's (input rows a block, channels a chunk, columns a thread): the
    chunk's channels a thread each (up to K5_CHUNK) and THREADS // chunk runs of
    columns; the most rows, up to 32, whose float sums fit SUM_BYTES and whose outputs a
    thread walks stay within OWNER_VISITS (one row at least); (0, 0, 0) where one row's
    sums do not fit."""
    chunk = min(c, K5_CHUNK)
    seg_w = -(-w // (THREADS // chunk))
    spans = [-(-(n - 1 + k) // s) for n, k, s in zip((1, 1, seg_w), window, strides)]  # outputs a run covers
    rows = min(h, 32, SUM_BYTES // (w * chunk * acc_size))
    while rows > 1 and spans[0] * -(-(rows - 1 + window[1]) // strides[1]) * spans[2] > OWNER_VISITS:
        rows -= 1
    return (rows, chunk, seg_w) if rows else (0, 0, 0)


def k5_plan(grad_out: torch.Tensor, indices: torch.Tensor, input_shape: Sequence[int], window: Sequence[int],
            strides: Sequence[int], channels_last: bool) -> K5Plan:
    """``_k5_plan`` for these operands (cached on their shapes, strides and alignment:
    the plan is host time on every backward)."""
    width = vector_width(grad_out.dtype)
    return _k5_plan(tuple(int(s) for s in input_shape), tuple(window), tuple(strides), grad_out.dtype,
                    tuple(grad_out.shape), grad_out.stride(), indices.stride(), channels_last,
                    vectors_fit(grad_out, width) and vectors_fit(indices, width))


@functools.lru_cache(maxsize=1024)
def _k5_plan(input_shape: tuple, window: tuple, strides: tuple, dtype: torch.dtype, out_shape: tuple,
             go_stride: tuple, ix_stride: tuple, channels_last: bool, vectors: bool) -> K5Plan:
    """K5's launch for these operands (csrc/maxpool3d.cu). The owner form for pools whose
    windows overlap in h or w but not in d (the stem's, 2a's, MViT-shaped ones: where the
    card ran it faster than the row form) where ``grad_in`` is channels_last_3d, grad_out
    and the indices have channel stride 1 and ``k5_owner`` finds a tile: blocks of (b, d,
    input rows) x a chunk of channels, each thread a (channel, run of columns) walking the
    outputs that cover them; 16-byte stores where C is a multiple of the vector width.
    Elsewhere the row form: rows (b, d, h) of W x C elements in channels_last_3d, (b, c,
    d, h) of W in NCDHW, each thread a (channel vector, column) gathering its windows,
    16-byte vectors where the layout allows (``vectors_fit``), else one element a thread
    (the generic path)."""
    b, c, d, h, w = input_shape
    width = vector_width(dtype)
    fits = max(sample_span(out_shape, go_stride), sample_span(out_shape, ix_stride), math.prod(input_shape[1:]),
               math.prod(input_shape[:4])) < 2 ** 31
    overlap = window[0] <= strides[0] and (window[1] > strides[1] or window[2] > strides[2])
    if overlap and channels_last and go_stride[1] == 1 and ix_stride[1] == 1:
        owner = k5_owner(h, w, c, 8 if dtype == torch.float64 else 4, window, strides)
        if owner[0]:
            vec = width if c % width == 0 and owner[1] % width == 0 else 1
            block = (owner[1], THREADS // owner[1], 1)
            return K5Plan(vec, True, block, (b * d * -(-h // owner[0]), -(-c // owner[1])), owner, fits)
    vec = width if channels_last and c % width == 0 and vectors else 1
    c_outer, c_inner = (1, c) if channels_last else (c, 1)
    rows = b * c_outer * d * h
    block = thread_block(c_inner // vec, w, rows, MAX_ROWS)
    grid = (-(-rows // block[2]), -(-w // block[1]))
    return K5Plan(vec, channels_last, block, grid, (0, 0, 0), fits and grid[1] < 2 ** 16)


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
    fn.argtypes = [p, p, p, i, p, p, p, p, p, p, p, p]
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
    if min(strides) < 1:
        raise ValueError(f"max_pool3d_backward: strides {strides} out of range")
    fmt = torch.channels_last_3d if channels_last else torch.contiguous_format
    grad_in = torch.empty(input_shape, dtype=grad_out.dtype, device=grad_out.device, memory_format=fmt)
    if grad_in.numel() == 0:
        return grad_in
    plan = k5_plan(grad_out, indices, input_shape, window, strides, channels_last)
    if not plan.fits:
        raise ValueError(f"max_pool3d_backward: K5 takes samples below 2^31 elements, below 2^31 rows "
                         f"and 2^16 column chunks, not {input_shape} ({plan.grid[1]} chunks)")
    shape = _ints(ctypes.c_int, input_shape + tuple(grad_out.shape[2:]))
    with torch.cuda.device(grad_out.device):
        err = _library()(grad_out.data_ptr(), indices.data_ptr(), grad_in.data_ptr(),
                         _DTYPES[grad_out.dtype], shape, _ints(ctypes.c_int, window),
                         _ints(ctypes.c_int, strides), _ints(ctypes.c_int, padding),
                         _ints(ctypes.c_longlong, grad_out.stride()),
                         _ints(ctypes.c_longlong, indices.stride()),
                         _ints(ctypes.c_int, (plan.vec, int(channels_last)) + plan.block + plan.owner),
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
