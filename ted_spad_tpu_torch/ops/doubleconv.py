"""Fused DoubleConv: relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2), SAME padding.

Counterpart of ted_spad_tpu/ops/pallas_doubleconv.py, the eval-mode ``DoubleConv``
of the plain UNet with BatchNorm (and the conv bias) folded into w/b by ``fold_bn``.
Layouts are the JAX package's: x (N, H, W, Cin), weights (3, 3, I, O), biases f32.

- ``double_conv_reference``: the plain version, two float32 ``F.conv2d`` calls. Its
  numerics are those of the JAX reference: products of the input dtype summed in
  float32, float32 bias, ReLU, the conv1 result rounded to the input dtype, then
  the same again for conv2 with the result in the input dtype.
- ``fused_double_conv``: the kernel wrapper (K2, csrc/doubleconv.cu). On a CUDA
  tensor it launches the hand-written kernel; on a CPU tensor it runs the plain
  version. Its ``launches`` attribute counts one per DoubleConv it runs on the card
  (the float32 form's two kernel launches included). K2 has no backward: on the card
  it refuses (``refuse_grad``) inputs that ask for a gradient.
- ``k2_tile_plan``: the bf16 kernel's tile class and shared memory for a shape,
  computed as the kernel lays them out; raises ``ValueError`` where no class fits.
- ``k2_f32_plan``: the float32 form's two passes (block tile, ring, shared memory,
  grid) and its conv1 scratch, likewise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F


def fold_bn(w: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = 1e-5,
            bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BN, and the conv's own bias if it has one, into the conv:
    returns (w * scale, beta + (bias - mean) * scale) with
    scale = gamma / sqrt(var + eps) per output channel, the last axis of ``w``."""
    scale = gamma / torch.sqrt(var + eps)
    shift = -mean if bias is None else bias - mean
    return w * scale, beta + shift * scale


def _conv3x3_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of NHWC ``x`` with HWIO ``w``, in float32: (N, H, W, O) f32."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(), padding=1)
    return y.permute(0, 2, 3, 1)


def double_conv_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version: (N, H, W, Cin) -> (N, H, W, Cout) in x.dtype. On the card,
    run it with TF32 off (utils/device.tf32_off) to keep its float32 convs exact."""
    y = torch.relu(_conv3x3_f32(x, w1) + b1.float()).to(x.dtype)
    return torch.relu(_conv3x3_f32(y, w2) + b2.float()).to(x.dtype)


_ERR_TOO_WIDE = -2  # csrc/doubleconv.cu: kErrTooWide
SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory an H100 block may opt into

# The bf16 tile classes of csrc/doubleconv.cu, the first whose Cmid limit holds is
# taken: (largest Cmid, TH, TW, warps along M, blocks per SM, warps per block). 4 n8
# tiles a warp, so the N chunk of both GEMMs is warps / WM * 32 channels; stages carry
# 16 input channels, and the ring holds two.
_K2_CLASSES = (
    (64, 16, 16, 7, 2, 7), (128, 16, 28, 8, 1, 8), (256, 14, 14, 4, 1, 8), (512, 7, 14, 4, 1, 8),
)


# The float32 form's implicit GEMM (csrc/doubleconv.cu, namespace f32): k rows per stage,
# ring stages, threads a block, blocks an SM, A rows padded to BK + 4 floats; block
# tiles (BM, BN) by Cout: the narrow one up to _K2_F32_NARROW_COUT, the wide one above.
_K2_F32_BK, _K2_F32_STAGES, _K2_F32_THREADS, _K2_F32_MIN_BLOCKS = 16, 3, 128, 3
_K2_F32_TILES = {"wide": (64, 128), "narrow": (128, 64)}
_K2_F32_NARROW_COUT = 64


class K2F32Pass(NamedTuple):
    cin: int
    cout: int
    tile: str  # "BMxBN": pixels x output channels of a block
    stages: int  # of the cp.async ring
    threads: int  # of a block
    smem_bytes: int  # dynamic shared memory of one block
    grid: tuple[int, int]  # (pixel tiles, output-channel tiles)
    k_stages: int  # stages of BK k rows over K = 9 * Cin
    copy_bytes: int  # of each cp.async of x: 16 where Cin % 4 == 0, else 4


class K2F32Plan(NamedTuple):
    passes: tuple[K2F32Pass, K2F32Pass]  # x -> scratch (Cin -> Cmid), scratch -> out
    scratch_bytes: int  # the float32 conv1 result, N * H * W * Cmid * 4


def k2_f32_pass(m: int, cin: int, cout: int) -> K2F32Pass:
    """One pass of the float32 form over ``m`` pixels, Cin -> Cout, as the kernel lays
    it out."""
    bm, bn = _K2_F32_TILES["narrow" if cout <= _K2_F32_NARROW_COUT else "wide"]
    bk = _K2_F32_BK
    smem = _K2_F32_STAGES * (bm * (bk + 4) + bk * bn) * 4
    k_stages = 9 * _cdiv(cin, bk) if cin % 4 == 0 else _cdiv(9 * cin, bk)
    return K2F32Pass(cin, cout, f"{bm}x{bn}", _K2_F32_STAGES, _K2_F32_THREADS, smem,
                     (_cdiv(m, bm), _cdiv(cout, bn)), k_stages, 16 if cin % 4 == 0 else 4)


def k2_f32_plan(n: int, h: int, w: int, cin: int, cmid: int, cout: int) -> K2F32Plan:
    """The float32 K2's two passes and scratch for N frames of (H, W) and Cin -> Cmid
    -> Cout. Raises ValueError where the kernel's index arithmetic would not hold: it
    keeps a pixel's row and column in 16 bits each and M = N * H * W in an int."""
    if min(n, h, w, cin, cmid, cout) <= 0:
        raise ValueError(f"k2_f32_plan: sizes must be positive, got {(n, h, w, cin, cmid, cout)}")
    m = n * h * w
    if h >= 2 ** 15 or w >= 2 ** 16 or m >= 2 ** 31:
        raise ValueError(f"K2's float32 form takes H < 32768, W < 65536 and N*H*W < 2**31, "
                         f"got {(n, h, w)}")
    return K2F32Plan((k2_f32_pass(m, cin, cmid), k2_f32_pass(m, cmid, cout)), m * cmid * 4)


class K2Plan(NamedTuple):
    tile_class: str  # "THxTW" outputs per block
    smem_bytes: int  # dynamic shared memory of one block
    kernel: str  # the instantiation, "bf16 Cls<TH, TW, WM, blocks, warps>"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align128(n: int) -> int:
    return _cdiv(n, 128) * 128


def k2_tile_plan(h: int, w: int, cin: int, cmid: int, cout: int) -> K2Plan:
    """The bf16 K2's tile class and shared memory for an (H, W) frame and Cin -> Cmid ->
    Cout, laid out as csrc/doubleconv.cu lays them out: the class is the first whose
    Cmid limit holds; shared memory holds the conv1 tile ((TH+2)(TW+2) pixels x Cmid
    rounded to the N chunk, plus 8 channels of padding) and two stages, each a
    16-channel patch chunk ((TH+4)(TW+4) pixels, rows of 24) and 9 x 16 weight rows of
    the N chunk plus 8. Raises ValueError where no class fits."""
    if min(h, w, cin, cmid, cout) <= 0:
        raise ValueError(f"k2_tile_plan: sizes must be positive, got {(h, w, cin, cmid, cout)}")
    for limit, *params in _K2_CLASSES:
        if cmid <= limit:
            break
    else:
        raise ValueError(f"K2 has no bf16 tile class for Cmid={cmid}: its conv1 tile must "
                         f"stay in shared memory, which holds Cmid <= {limit}")
    th, tw, wm, _, warps = params
    nc = warps // wm * 32
    mid = (th + 2) * (tw + 2) * (_cdiv(cmid, nc) * nc + 8) * 2
    stage = (th + 4) * (tw + 4) * 24 * 2 + 9 * 16 * (nc + 8) * 2
    smem = _align128(mid) + 2 * _align128(stage)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"K2's {th}x{tw} tile at Cmid={cmid} needs {smem} B of shared "
                         f"memory, more than a block's {SMEM_PER_BLOCK}")
    return K2Plan(f"{th}x{tw}", smem, f"bf16 Cls<{', '.join(map(str, params))}>")


@functools.cache
def _library():
    from ted_spad_tpu_torch.utils.cuda_build import load

    fn = load("doubleconv").ted_double_conv
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.restype = i
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    return fn


def _check(x, w1, b1, w2, b2) -> None:
    if x.dim() != 4:
        raise ValueError(f"fused_double_conv takes x of shape (N, H, W, Cin), got {tuple(x.shape)}")
    n, h, w, cin = x.shape
    cmid, cout = w1.shape[-1], w2.shape[-1]
    shapes = {"w1": (w1, (3, 3, cin, cmid)), "b1": (b1, (cmid,)),
              "w2": (w2, (3, 3, cmid, cout)), "b2": (b2, (cout,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"fused_double_conv: {name} has shape {tuple(t.shape)}, "
                             f"expected {want} for x {tuple(x.shape)}")
        if t.device != x.device:
            raise ValueError(f"fused_double_conv: {name} on {t.device}, x on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_double_conv takes float32 or bfloat16 x, not {x.dtype}")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError(f"fused_double_conv: weights {w1.dtype}/{w2.dtype} must match x {x.dtype}")
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise ValueError(f"fused_double_conv: biases must be float32, got {b1.dtype}/{b2.dtype}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if not t.is_contiguous():
            raise ValueError(f"fused_double_conv: {name} must be contiguous (for x: the NHWC "
                             "view of a channels_last tensor); it would be copied")


def refuse_grad(*tensors: torch.Tensor) -> None:
    """Raise where autograd would record through K2: grad mode on and any of
    ``tensors`` requiring grad. K2 writes its output through raw pointers, so the
    output would carry no ``grad_fn`` and the caller's gradient would be cut
    silently; eval-mode callers next to an autograd graph run under ``no_grad``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("fused_double_conv: kernel K2 has no backward, and an input "
                           "requires grad; run it under torch.no_grad() (a frozen fa) or "
                           "in train mode (unfolded ConvBNs)")


def fused_double_conv(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2), SAME padding, BN folded.

    x: (N, H, W, Cin) float32 or bfloat16, any H and W, contiguous (the NHWC view
    ``t.permute(0, 2, 3, 1)`` of a ``channels_last`` NCHW tensor is);
    w1: (3, 3, Cin, Cmid) and w2: (3, 3, Cmid, Cout) in x.dtype; b1, b2: float32.
    Returns (N, H, W, Cout) in x.dtype, contiguous. On CUDA this launches kernel K2
    on the current stream, and raises ``RuntimeError`` under grad mode when an input
    requires grad (``refuse_grad``); on the CPU it runs ``double_conv_reference``,
    which is differentiable. The float32 form is two kernel launches, conv1 into a
    float32 scratch of N*H*W*Cmid (``k2_f32_plan``) and conv2 from it; ``launches``
    counts the call once, as for bf16's one launch.
    """
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return double_conv_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_double_conv runs on cuda or cpu, not {x.device}")
    refuse_grad(x, w1, b1, w2, b2)
    n, h, w, cin = x.shape
    cmid, cout = w1.shape[-1], w2.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    if n <= 0 or h * w == 0 or (bf16 and n > 65535):
        raise ValueError(f"fused_double_conv takes 1 to 65535 frames of a non-empty image in "
                         f"bfloat16 (one grid row per frame), any count in float32; got x "
                         f"{tuple(x.shape)} {x.dtype}")
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("fused_double_conv: x, w1 and w2 must start on a 16-byte boundary "
                         "(the kernel reads them 16 bytes at a time)")
    if bf16:
        k2_tile_plan(h, w, cin, cmid, cout)  # raises where no tile class fits
        mid = None
    else:
        k2_f32_plan(n, h, w, cin, cmid, cout)  # raises where the index arithmetic would not hold
        mid = torch.empty((n, h, w, cmid), dtype=torch.float32, device=x.device)
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _library()(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            None if mid is None else mid.data_ptr(), out.data_ptr(), int(bf16), n, h, w, cin,
            cmid, cout, torch.cuda.current_stream().cuda_stream,
        )
    if err == _ERR_TOO_WIDE:
        raise ValueError(f"fused_double_conv: the conv1 tile of Cmid={cmid} in {x.dtype} does "
                         "not fit in a block's shared memory")
    if err != 0:
        raise RuntimeError(f"fused_double_conv: kernel launch failed with cudaError {err}")
    fused_double_conv.launches += 1
    return out


fused_double_conv.launches = 0
