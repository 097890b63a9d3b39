"""The deterministic backward kernels' plain versions against JAX and torch, on the CPU.

K5 (ops/maxpool3d.py) and K6 (ops/upsample.py) replace torch's atomic CUDA backwards of
the 3D max pools and of the UNet's bilinear upsample. Their plain versions, which the
CPU runs and which the card holds each kernel against bit for bit, are held here:

- K5's against ``jax.grad`` of the JAX package's own pooling (``max_pool_valid``,
  ``max_pool_same``: ted_spad_tpu/models/layers.py:84-100; MViTv2's skip pool, a
  ``-inf`` pad then VALID, ted_spad_tpu/models/mvit.py:151) at every window, stride and
  padding a training path pools with, in float32 and float64, with planted ties (small
  integers: most windows hold several maxima, so the tie-breaking is held too).
  Integer-valued output gradients sum exactly: bit-equal. Random ones: 1e-6 of the
  largest gradient in float32 and 1e-12 in float64 (the summation order differs).
- K5's against ``F.max_pool3d``'s own CPU backward in NCDHW and channels_last_3d, the
  gradient in the input's memory format.
- K6's against ``jax.grad`` of JAX's ``resize_bilinear`` (layers.py:109, float32 weights
  from i (in - 1) / (out - 1), where torch takes scale * i: 4 max(h, w) 2^-24 of the
  largest gradient, an ulp of the source coordinate) and against ``F.interpolate``'s
  backward (1e-6 in float32, 1e-12 in float64), at odd and even sizes, NCHW and
  channels_last.
- Emulations of the kernels as their wrappers' plans launch them (``k5_plan``,
  ``k6_plan``: blocks, rows or bands, threads, vector lanes and the lane loop, K6's
  row-tap table, column taps and ring of two rows, every read through the operands'
  strides, numpy rounding each operation as the card does) bit-equal to the plain
  versions, each element of grad_in stored once: the order the two share is the
  kernels'.
- Routing: on a tiny train step of each family (I3Res50, InceptionI3d, MViTv2-S, the
  plain-UNet fa) every 3D max pool and every bilinear upsample under grad goes through
  the new autograd Functions, and none does under ``no_grad``.
- ``deterministic_cudnn`` sets and restores cuDNN's flag.
- The card's check of every recorded call (``chip_probes.recorded_backward_calls`` /
  ``check_recorded``) keeps each call's full shape, dtype and layout.

Torch on one thread.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from ted_spad_tpu.models import layers as jax_layers
from ted_spad_tpu_torch.models import layers
from ted_spad_tpu_torch.ops import maxpool3d, upsample
from ted_spad_tpu_torch.ops.maxpool3d import max_pool3d, max_pool3d_backward_reference
from ted_spad_tpu_torch.ops.upsample import upsample_bilinear, upsample_bilinear_backward_reference
from ted_spad_tpu_torch.utils.device import deterministic_cudnn

torch.set_num_threads(1)

# (name, input (B, C, D, H, W), window, strides, JAX pooling): the 3D pools of the
# training paths (ROADMAP: the I3Res50's stem, layer1 and non-local pools; InceptionI3d's
# SAME trunk and branch pools; MViTv2-S's padded skip pool).
POOLS = {
    "i3res50 stem (2,3,3)/(2,2,2)": ((2, 3, 6, 9, 11), (2, 3, 3), (2, 2, 2), "valid"),
    "i3res50 layer1 (2,1,1)/(2,1,1)": ((2, 3, 5, 4, 5), (2, 1, 1), (2, 1, 1), "valid"),
    "i3res50 non-local (1,2,2)/(1,2,2)": ((2, 3, 3, 7, 6), (1, 2, 2), (1, 2, 2), "valid"),
    "i3d 2a/3a (1,3,3)/(1,2,2) SAME": ((2, 3, 4, 9, 8), (1, 3, 3), (1, 2, 2), "same"),
    "i3d 4a (3,3,3)/(2,2,2) SAME": ((2, 3, 7, 8, 9), (3, 3, 3), (2, 2, 2), "same"),
    "i3d 5a (2,2,2)/(2,2,2) SAME": ((2, 3, 5, 6, 7), (2, 2, 2), (2, 2, 2), "same"),
    "i3d branch (3,3,3)/(1,1,1) SAME": ((2, 3, 4, 5, 6), (3, 3, 3), (1, 1, 1), "same"),
    "mvit skip (1,3,3)/(1,2,2) pad (0,1,1)": ((2, 3, 3, 8, 7), (1, 3, 3), (1, 2, 2), "mvit"),
}
TOL = {"float32": 1e-6, "float64": 1e-12}


def _jax_pool(kind: str, window, strides):
    """The JAX package's pooling over (B, D, H, W, C) for ``kind``."""
    if kind == "valid":
        return lambda x: jax_layers.max_pool_valid(x, window, strides)
    if kind == "same":
        return lambda x: jax_layers.max_pool_same(x, window, strides)
    pads = [(0, 0)] + [(k // 2, k // 2) for k in window] + [(0, 0)]  # mvit.py:151
    return lambda x: nn.max_pool(jnp.pad(x, pads, constant_values=-jnp.inf), window,
                                 strides=strides, padding="VALID")


def _port_pool(kind: str, window, strides):
    """The port's pooling over (B, C, D, H, W) for ``kind``, as the models call it."""
    if kind == "valid":
        return lambda x: layers.max_pool_valid(x, window, strides)
    if kind == "same":
        return lambda x: layers.max_pool_same(x, window, strides)
    return lambda x: max_pool3d(x, window, strides, tuple(k // 2 for k in window))


def _pool_inputs(shape, dtype: str, integer_grad: bool, seed: int):
    """(x with planted ties (B, C, D, H, W), a function of the pool's output shape giving
    the output gradient: integers, or normal values)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, shape).astype(dtype)

    def grad(out_shape):
        values = rng.integers(-4, 5, out_shape) if integer_grad else rng.standard_normal(out_shape)
        return values.astype(dtype)

    return x, grad


@pytest.mark.parametrize("integer_grad", [True, False], ids=["exact", "random"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_k5_plain_matches_jax_gradient(pool, dtype, integer_grad):
    shape, window, strides, kind = POOLS[pool]
    x, grad_of = _pool_inputs(shape, dtype, integer_grad, seed=sorted(POOLS).index(pool))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = _port_pool(kind, window, strides)(xt)
    g = grad_of(tuple(out.shape))
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    with jax.enable_x64(dtype == "float64"):
        xj = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
        gj = jnp.asarray(g.transpose(0, 2, 3, 4, 1))
        fn = _jax_pool(kind, window, strides)
        jout, vjp = jax.vjp(fn, xj)
        (want,) = vjp(gj)
        want = np.asarray(want).transpose(0, 4, 1, 2, 3)
        np.testing.assert_array_equal(np.asarray(out.detach()),
                                      np.asarray(jout).transpose(0, 4, 1, 2, 3))
    assert want.dtype == np.dtype(dtype)
    if integer_grad:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= TOL[dtype], err


@pytest.mark.parametrize("channels_last", [False, True], ids=["ncdhw", "channels_last_3d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_k5_plain_matches_torch_backward(pool, dtype, channels_last):
    shape, window, strides, kind = POOLS[pool]
    padding = tuple(k // 2 for k in window) if kind == "mvit" else (0, 0, 0)
    g = torch.Generator().manual_seed(3)
    x = torch.randint(-2, 3, shape, generator=g).to(dtype)
    if kind == "same":
        x = layers.pad_tf_same(x, window, strides, value=torch.finfo(dtype).min)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last_3d)
    out, idx = F.max_pool3d(x, window, strides, padding, return_indices=True)
    grad = torch.randn(out.shape, generator=g).to(dtype)
    got = max_pool3d_backward_reference(grad, idx, x.shape, window, strides, padding, channels_last)
    want = torch.ops.aten.max_pool3d_with_indices_backward(grad, x, window, strides, padding, (1, 1, 1),
                                                            False, idx)
    # torch's CPU backward adds each element's windows in output order, as K5 does; in
    # bf16 it rounds after every add where K5 rounds once, so bf16 is held to one ulp.
    tol = {torch.float32: 1e-6, torch.float64: 1e-12, torch.bfloat16: 2.0 ** -7}[dtype]
    assert float((got.double() - want.double()).abs().max()) <= tol * float(want.double().abs().max())
    fmt = torch.channels_last_3d if channels_last else torch.contiguous_format
    assert got.dtype == dtype and got.is_contiguous(memory_format=fmt)
    # Through the Function, the gradient keeps the input's layout too.
    xt = x.detach().clone().requires_grad_(True)
    (through,) = torch.autograd.grad(max_pool3d(xt, window, strides, padding), xt, grad)
    assert torch.equal(through, got) and through.is_contiguous(memory_format=fmt)


UPSAMPLES = [(1, 1), (1, 4), (2, 2), (3, 5), (4, 7), (7, 4), (14, 14), (13, 17)]


@pytest.mark.parametrize("hw", UPSAMPLES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_k6_plain_matches_jax_gradient(hw):
    h, w = hw
    rng = np.random.default_rng(h * 31 + w)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    g = rng.standard_normal((2, 2 * h, 2 * w, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_layers.resize_bilinear(a, 2), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0]).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    out = layers.resize_bilinear(xt, 2)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
    # JAX's source coordinate i (in - 1) / (out - 1) and torch's scale * i differ by an
    # ulp, up to max(h, w) x 2^-24 of a weight: 4 of those of the largest gradient.
    tol = 4 * max(h, w) * 2.0 ** -24
    assert float(np.abs(got.numpy() - want).max()) <= tol * float(np.abs(want).max())


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hw", UPSAMPLES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_k6_plain_matches_torch_backward(hw, dtype, channels_last):
    h, w = hw
    g = torch.Generator().manual_seed(h * 31 + w)
    x = torch.randn((2, 5, h, w), generator=g, dtype=dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    grad = torch.randn((2, 5, 2 * h, 2 * w), generator=g, dtype=dtype)
    got = upsample_bilinear_backward_reference(grad, x.shape, channels_last)
    want = torch.ops.aten.upsample_bilinear2d_backward(grad, [2 * h, 2 * w], list(x.shape), True, None, None)
    tol = {torch.float32: 1e-6, torch.float64: 1e-12}[dtype]
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert got.is_contiguous(memory_format=fmt)
    xt = x.detach().clone().requires_grad_(True)
    out = upsample_bilinear(xt)
    assert torch.equal(out, F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=True))
    (through,) = torch.autograd.grad(out, xt, grad)
    assert torch.equal(through, got) and through.is_contiguous(memory_format=fmt)


def _storage(t: torch.Tensor) -> np.ndarray:
    """The flat elements under ``t`` from its first one on (as float64 for bf16, which
    converts exactly), for reads through its strides."""
    flat = t.as_strided((t.untyped_storage().nbytes() // t.element_size() - t.storage_offset(),), (1,))
    return (flat.double() if t.dtype == torch.bfloat16 else flat).numpy()


def _window_range(i, pad, k, s, n):
    first = i + pad - k + 1
    lo = 0 if first <= 0 else (first + s - 1) // s
    return lo, min((i + pad) // s, n - 1)


def _emulate_k5(grad, idx, shape, window, strides, padding, channels_last: bool):
    """csrc/maxpool3d.cu as ``k5_plan`` launches it, on the CPU. The row form: the grid's
    blocks, each block's rows (b, c_outer, d, h) with what one thread computes for them
    (window ranges, the row target, the offsets at the first window), the threads'
    columns w and channel vectors (the lane loop past the block's width), each vector's
    windows in ascending (od, oh, ow) order read through the operands' strides, its lanes
    compared with the one target. The owner form: each block's (b, d, input rows) x
    channel chunk with its sums, each thread's (channel, run of columns) walking the
    outputs that cover them in ascending order, the argmax's low word decoded by the
    magic division and added where it names an element of the thread's, then the rows
    written out a cell's vectors together. Sums in the accumulator's type (float32,
    float64 for float64), rounded once. Returns grad_in in its layout and each element's
    store count."""
    plan = maxpool3d.k5_plan(grad, idx, shape, window, strides, channels_last)
    acc_type = np.float64 if grad.dtype == torch.float64 else np.float32
    b, c, d, h, w = shape
    od, oh, ow = grad.shape[2:]
    (kd, kh, kw), (sd, sh, sw), (pd, ph, pw) = window, strides, padding
    c_outer, c_inner = (1, c) if channels_last else (c, 1)
    vec, (bx, by, bz), (gx, gy) = plan.vec, plan.block, plan.grid
    rows = b * c_outer * d * h
    go, ix = _storage(grad), _storage(idx)
    gs, js = grad.stride(), idx.stride()
    out = np.zeros(rows * w * c_inner, acc_type)
    stores = np.zeros(out.shape, np.int64)
    lanes = np.arange(vec)

    def gather(acc, hit, g):
        return np.where(hit, acc + g.astype(acc_type), acc) if hit.any() else acc

    if plan.owner[0]:
        tile_h, chunk, seg_w = plan.owner
        n_tiles = -(-h // tile_h)
        magic, shift = _div_magic(w)
        for block_x, block_y in np.ndindex(gx, gy):
            zd, tile = divmod(block_x, n_tiles)
            bi, zd = divmod(zd, d)
            ha, hb = tile * tile_h, min(tile * tile_h + tile_h, h)
            c0 = block_y * chunk
            cc = min(chunk, c - c0)
            sums = np.zeros((hb - ha, w, chunk), acc_type)  # the block's shared memory
            for s_y, ch in np.ndindex(by, bx):  # thread (channel, run of columns)
                wa, wb = s_y * seg_w, min(s_y * seg_w + seg_w, w)
                if ch >= cc or wa >= wb:
                    continue
                (d0, d1), h0, h1 = (_window_range(zd, pd, kd, sd, od), _window_range(ha, ph, kh, sh, oh)[0],
                                    _window_range(hb - 1, ph, kh, sh, oh)[1])
                w0, w1 = _window_range(wa, pw, kw, sw, ow)[0], _window_range(wb - 1, pw, kw, sw, ow)[1]
                for a, e, f in np.ndindex(max(d1 - d0 + 1, 0), max(h1 - h0 + 1, 0), max(w1 - w0 + 1, 0)):
                    at = (bi, c0 + ch, d0 + a, h0 + e, w0 + f)
                    m = int(ix[sum(i * st for i, st in zip(at, js))]) & 0xFFFFFFFF  # the low word
                    r = (m - zd * h * w) & 0xFFFFFFFF
                    if r >= h * w:
                        continue
                    zh = (r * magic) >> shift
                    zw = r - zh * w
                    if ha <= zh < hb and wa <= zw < wb:
                        g = go[sum(i * st for i, st in zip(at, gs))]
                        sums[zh - ha, zw, ch] = acc_type(sums[zh - ha, zw, ch] + acc_type(g))
            vectors = chunk // vec
            for t in range(bx * by):  # the rows out, a cell's vectors together
                cv = t % vectors
                if t >= bx * by // vectors * vectors or cv * vec >= cc:
                    continue
                for cell in range(t // vectors, (hb - ha) * w, bx * by // vectors):
                    at = ((bi * d + zd) * h + ha) * w * c + cell * c + c0 + cv * vec + lanes
                    out[at] += sums[cell // w, cell % w, cv * vec + lanes]
                    stores[at] += 1
    else:
        for block_x, block_y in np.ndindex(gx, gy):
            for z in range(bz):
                r = block_x * bz + z
                if r >= rows:
                    continue
                q = r
                zh = q % h; q //= h
                zd = q % d; q //= d
                co, bi = q % c_outer, q // c_outer
                (d0, d1), (h0, h1) = _window_range(zd, pd, kd, sd, od), _window_range(zh, ph, kh, sh, oh)
                target = (zd * h + zh) * w
                go_row = bi * gs[0] + co * gs[1] + d0 * gs[2] + h0 * gs[3]
                ix_row = bi * js[0] + co * js[1] + d0 * js[2] + h0 * js[3]
                for y, x in np.ndindex(by, bx):
                    zw = block_y * by + y
                    if zw >= w:
                        continue
                    w0, w1 = _window_range(zw, pw, kw, sw, ow)
                    for cv in range(x, c_inner // vec, bx):
                        acc = np.zeros(vec, acc_type)
                        for a, e, f in np.ndindex(d1 - d0 + 1, h1 - h0 + 1, w1 - w0 + 1):
                            at = a * js[2] + e * js[3] + (w0 + f) * js[4] + cv * vec * js[1] + lanes
                            g_at = a * gs[2] + e * gs[3] + (w0 + f) * gs[4] + cv * vec * gs[1] + lanes
                            acc = gather(acc, ix[ix_row + at] == target + zw, go[go_row + g_at])
                        at = r * w * c_inner + zw * c_inner + cv * vec + lanes
                        out[at] += acc
                        stores[at] += 1
    fmt = torch.channels_last_3d if channels_last else torch.contiguous_format
    dense = torch.empty(shape, dtype=grad.dtype, memory_format=fmt)
    got = torch.from_numpy(out).to(grad.dtype).as_strided(shape, dense.stride())
    return got, stores


def _div_magic(w: int) -> tuple[int, int]:
    """The owner form's division (csrc/maxpool3d.cu's entry): r // w == (r m) >> shift for
    0 <= r < 2^31, with m = ceil(2^(31 + l) / w), l = ceil(log2 w), and shift = 31 + l."""
    shift = 31 + (w - 1).bit_length()
    return -(-(1 << shift) // w), shift


def _k5_operands(shape, window, strides, padding, dtype, channels_last: bool, seed: int):
    """(grad_out, indices) of a pool over small integers (planted ties) in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-2, 3, shape, generator=g).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last_3d)
    out, idx = F.max_pool3d(x, window, strides, padding, return_indices=True)
    return torch.empty_like(out).copy_(torch.randn(out.shape, generator=g).to(dtype)), idx


def _k5_emulation_check(grad, idx, shape, window, strides, padding, channels_last):
    got, stores = _emulate_k5(grad, idx, shape, window, strides, padding, channels_last)
    want = max_pool3d_backward_reference(grad, idx, shape, window, strides, padding, channels_last)
    assert (stores == 1).all(), "every element of grad_in is stored once"
    assert torch.equal(got, want)
    return maxpool3d.k5_plan(grad, idx, shape, window, strides, channels_last)


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_k5_loop_emulation_is_bit_equal_to_plain(pool):
    shape, window, strides, kind = POOLS[pool]
    padding = tuple(k // 2 for k in window) if kind == "mvit" else (0, 0, 0)
    for channels_last in (False, True):
        grad, idx = _k5_operands(shape, window, strides, padding, torch.float32, channels_last, seed=5)
        plan = _k5_emulation_check(grad, idx, shape, window, strides, padding, channels_last)
        overlap = window[0] <= strides[0] and (window[1] > strides[1] or window[2] > strides[2])
        assert (plan.vec, bool(plan.owner[0])) == (1, channels_last and overlap)  # C = 3: one-element stores


# channels_last_3d shapes of the vector stores: C two vectors (8 float32, 16 bf16, 4
# float64), and C two vectors and a tail (one-element stores); the stem's pool (the owner
# form; with the indices in NCDHW the row form) and a stride-1 (3,3,3) pool padded at
# every face (the row form), and MViT's skip pool on a permuted slice of its grad_out.
@pytest.mark.parametrize("dtype,c", [(torch.float32, 8), (torch.float32, 9), (torch.bfloat16, 16),
                                     (torch.bfloat16, 17), (torch.float64, 4)], ids=str)
def test_k5_vector_emulation_is_bit_equal_to_plain(dtype, c):
    vec = maxpool3d.vector_width(dtype) if c % 2 == 0 else 1
    for shape, window, strides, padding, owner in (((2, c, 4, 7, 9), (2, 3, 3), (2, 2, 2), (0, 0, 0), True),
                                                   ((2, c, 3, 4, 5), (3, 3, 3), (1, 1, 1), (1, 1, 1), False)):
        grad, idx = _k5_operands(shape, window, strides, padding, dtype, True, seed=c)
        plan = _k5_emulation_check(grad, idx, shape, window, strides, padding, True)
        assert (plan.vec, bool(plan.owner[0])) == (vec, owner)
        if owner:
            plan = _k5_emulation_check(grad, idx.contiguous(), shape, window, strides, padding, True)
            assert (plan.vec, bool(plan.owner[0])) == (1, False)
    x = torch.randint(-2, 3, (2, c, 3, 9, 7), generator=torch.Generator().manual_seed(1)).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    out, idx = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1), return_indices=True)
    view = torch.randn((2, 3, 5, 4, 2 * c), generator=torch.Generator().manual_seed(2)).to(dtype)
    grad = view[..., c:].permute(0, 4, 1, 2, 3)
    assert not grad.is_contiguous(memory_format=torch.channels_last_3d)
    plan = _k5_emulation_check(grad, idx, tuple(x.shape), (1, 3, 3), (1, 2, 2), (0, 1, 1), True)
    assert (plan.vec, bool(plan.owner[0])) == (vec, True)


def test_k5_owner_plan_and_division():
    """The owner form's plan: a chunk of up to K5_CHUNK channels, THREADS // chunk runs of
    columns, the most rows whose float sums fit SUM_BYTES and whose outputs a thread
    walks stay within OWNER_VISITS (the stem pool: 3 rows of 112 x 32 float32 sums, 42 KB,
    3 x 8 outputs a thread; a (3,3,3)/(1,1,1) pool: one row, 3 x 3 x 6); none where one
    row's sums do not fit. Its h = r // W by a multiply and a shift, exact below 2^31."""
    assert maxpool3d.k5_owner(112, 112, 64, 4, (2, 3, 3), (2, 2, 2)) == (3, 32, 14)
    assert maxpool3d.k5_owner(30, 30, 192, 2, (3, 3, 3), (1, 1, 1)) == (1, 32, 4)
    assert maxpool3d.k5_owner(8, 5, 3, 8, (1, 1, 1), (1, 1, 1)) == (8, 3, 1)
    assert maxpool3d.k5_owner(8, 20000, 64, 4, (1, 1, 1), (1, 1, 1)) == (0, 0, 0)
    rng = np.random.default_rng(0)
    for w in list(range(1, 300)) + [2 ** 20 + 1, 2 ** 31 - 1]:
        magic, shift = _div_magic(w)
        assert magic < 2 ** 32
        for r in [0, w - 1, w, 2 ** 31 - 1, *rng.integers(0, 2 ** 31, 20).tolist()]:
            assert (r * magic) >> shift == r // w


def _tap(o, i, n_in, scale, t):
    """csrc/upsample_bilinear.cu's ``tap`` in numpy scalars of type ``t``: output o's
    weight on input i, or None where o does not read i."""
    src = t(scale * t(o))
    i0 = int(src)
    i1 = i0 + (1 if i0 < n_in - 1 else 0)
    if i0 != i and i1 != i:
        return None
    lam1 = t(src - t(i0))
    lam0 = t(t(1) - lam1)
    return t((lam0 if i0 == i else t(0)) + (lam1 if i1 == i else t(0)))


def _emulate_k6(grad, shape, channels_last: bool):
    """csrc/upsample_bilinear.cu as ``k6_plan`` launches it, on the CPU in numpy scalars of
    the data's type: the grid's blocks (a plane's band of input rows x a run of columns
    x a run of channel vectors),
    the band's row-tap table (each output row's first tap and the band rows it feeds,
    with their weights), each thread's 8 candidate column taps, its channel vectors (the
    lane loop), and the walk down the band's output rows: t once per output row (ox
    ascending), wy t into the ring of two input rows, a row stored once the first tap
    passes it. Returns grad_in in its layout and each element's store count."""
    plan = upsample.k6_plan(grad, shape, channels_last)
    t = np.float64 if grad.dtype == torch.float64 else np.float32
    n, c, h, w = shape
    oh, ow = 2 * h, 2 * w
    sy, sx = t(h - 1) / t(oh - 1), t(w - 1) / t(ow - 1)
    c_outer, c_inner = (1, c) if channels_last else (c, 1)
    vec, (bx, by), band, (gx, gy, gz) = plan.vec, plan.block, plan.band, plan.grid
    n_bands = -(-h // band)
    go, gs = _storage(grad), grad.stride()
    out = np.zeros(n * c_outer * h * w * c_inner, t)
    stores = np.zeros(out.shape, np.int64)
    lanes = np.arange(vec)
    for block_x, block_y, block_z in np.ndindex(gx, gy, gz):
        plane, bi = divmod(block_x, n_bands)
        ia, ib = bi * band, min(bi * band + band, h)
        oa, ob = max(0, 2 * ia - 3), min(oh - 1, 2 * (ib - 1) + 4)
        taps = []
        for oy in range(oa, ob + 1):
            i0 = int(t(sy * t(oy)))
            i1 = i0 + (1 if i0 < h - 1 else 0)
            fed = [(r, _tap(oy, r, h, sy, t)) for r in dict.fromkeys((i0, i1))
                   if ia <= r < ib and 2 * r - 3 <= oy <= 2 * r + 4]
            taps.append((i0, [(r, wy) for r, wy in fed if wy is not None]))
        for y, x in np.ndindex(by, bx):
            col = block_y * by + y
            if col >= w:
                continue
            wx = [(2 * col - 3 + j, _tap(2 * col - 3 + j, col, w, sx, t)) for j in range(8)]
            wx = [(ox, wt) for ox, wt in wx if 0 <= ox < ow and wt is not None]
            base = (plane // c_outer) * gs[0] + (plane % c_outer) * gs[1]
            for cv in range(block_z * bx + x, c_inner // vec, gz * bx):
                ring, cur = [np.zeros(vec, t), np.zeros(vec, t)], ia

                def store(row, acc):
                    at = ((plane * h + row) * w + col) * c_inner + cv * vec + lanes
                    out[at] += acc
                    stores[at] += 1

                for oy, (i0, fed) in zip(range(oa, ob + 1), taps):
                    while i0 > cur and cur < ib:
                        store(cur, ring[0])
                        ring, cur = [ring[1], np.zeros(vec, t)], cur + 1
                    if cur >= ib:
                        break
                    if not fed:
                        continue
                    row_sum = np.zeros(vec, t)
                    for ox, wt in wx:
                        g = go[base + oy * gs[2] + ox * gs[3] + cv * vec * gs[1] + lanes].astype(t)
                        row_sum = (row_sum + (wt * g).astype(t)).astype(t)
                    for r, wy in fed:
                        ring[r - cur] = (ring[r - cur] + (wy * row_sum).astype(t)).astype(t)
                for row in range(cur, ib):
                    store(row, ring[0])
                    ring = [ring[1], np.zeros(vec, t)]
    dense = torch.empty(shape, dtype=grad.dtype,
                        memory_format=torch.channels_last if channels_last else torch.contiguous_format)
    return torch.from_numpy(out).as_strided(shape, dense.stride()), stores


def _k6_emulation_check(grad, shape, channels_last):
    got, stores = _emulate_k6(grad, shape, channels_last)
    want = upsample_bilinear_backward_reference(grad, shape, channels_last)
    assert (stores == 1).all(), "every element of grad_in is stored once"
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (5, 4), (9, 7)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_k6_loop_emulation_is_bit_equal_to_plain(hw, dtype):
    h, w = hw
    grad = torch.randn((1, 2, 2 * h, 2 * w), generator=torch.Generator().manual_seed(7), dtype=dtype)
    for channels_last in (False, True):
        _k6_emulation_check(grad.contiguous(memory_format=torch.channels_last if channels_last
                                            else torch.contiguous_format), (1, 2, h, w), channels_last)


# channels_last shapes of the vector path: C two vectors and two vectors and a tail (one
# element a thread), a last band shorter than K6_BAND, and grad_out in another layout.
@pytest.mark.parametrize("dtype,c", [(torch.float32, 8), (torch.float32, 9), (torch.float64, 4)], ids=str)
def test_k6_vector_emulation_is_bit_equal_to_plain(dtype, c):
    shape = (1, c, upsample.K6_BAND + 3, 5)
    grad = torch.randn((1, c, 2 * shape[2], 10), generator=torch.Generator().manual_seed(c), dtype=dtype)
    grad = grad.contiguous(memory_format=torch.channels_last)
    assert upsample.k6_plan(grad, shape, True).vec == (maxpool3d.vector_width(dtype) if c % 2 == 0 else 1)
    _k6_emulation_check(grad, shape, True)
    _k6_emulation_check(grad.contiguous(), shape, True)


@contextlib.contextmanager
def _routing_counts():
    """Counts inside the block: the two Functions' forwards, and the 3D max pools and
    bilinear upsamples that ran with grad on for an input that requires grad outside
    them (the Functions' own forwards run with grad off)."""
    counts = {"pool Function": 0, "upsample Function": 0, "pool outside": 0, "upsample outside": 0}
    real_pool, real_interp = F.max_pool3d, F.interpolate
    real_apply = {maxpool3d._MaxPool3d: maxpool3d._MaxPool3d.apply,
                  upsample._UpsampleBilinear: upsample._UpsampleBilinear.apply}

    def pool(x, *a, **k):
        if torch.is_grad_enabled() and x.requires_grad:
            counts["pool outside"] += 1
        return real_pool(x, *a, **k)

    def interp(x, *a, **k):
        if k.get("mode") == "bilinear" and torch.is_grad_enabled() and x.requires_grad:
            counts["upsample outside"] += 1
        return real_interp(x, *a, **k)

    def applying(cls, key):
        def apply(*a):
            counts[key] += 1
            return real_apply[cls](*a)
        return apply

    F.max_pool3d, F.interpolate = pool, interp
    maxpool3d._MaxPool3d.apply = applying(maxpool3d._MaxPool3d, "pool Function")
    upsample._UpsampleBilinear.apply = applying(upsample._UpsampleBilinear, "upsample Function")
    try:
        yield counts
    finally:
        F.max_pool3d, F.interpolate = real_pool, real_interp
        for cls, fn in real_apply.items():
            cls.apply = fn


def _family_loss(family: str):
    """A function giving the train forward's scalar loss on a seeded batch for
    ``family`` at a tiny size: the I3Res50 (tiny, 8 x 32^2), InceptionI3d (full width at
    its smallest clip, 9 x 193^2) and MViTv2-S (full width, 4 x 16^2) fts through the
    stages' train form, and the plain-UNet fa in train mode (32^2)."""
    from ted_spad_tpu_torch.cli import I3D_SMALLEST_CLIP
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
    from ted_spad_tpu_torch.ops.fast_i3d import make_fast_ft_train_forward

    g = torch.Generator().manual_seed(0)
    if family == "unet":
        fa = load_fa_model("unet", dtype="float32", device="cpu").requires_grad_(True)
        x = torch.rand((2, 3, 32, 32), generator=g)
        return lambda: fa(x, train=True).sum()
    clip = {"largei3d": (8, 32, 32), "i3d": I3D_SMALLEST_CLIP, "mvitv2": (4, 16, 16)}[family]
    ft = load_ft_model(family, num_classes=5, clip_shape=clip, dtype="float32", device="cpu",
                       tiny=family == "largei3d").requires_grad_(True)
    forward = make_fast_ft_train_forward(ft)
    x = torch.rand((1, 3) + clip, generator=g)
    gen = torch.Generator().manual_seed(1)

    def loss():
        logits, feat = forward(x, generator=gen)
        return logits.sum() + feat.sum()
    return loss


@pytest.mark.parametrize("family", ["largei3d", "i3d", "mvitv2", "unet"])
def test_training_routes_pools_and_upsamples_through_the_functions(family):
    loss = _family_loss(family)
    with _routing_counts() as counts:
        loss().backward()
    assert counts["pool outside"] == 0 and counts["upsample outside"] == 0, counts
    if family == "unet":
        assert counts["upsample Function"] == 4 and counts["pool Function"] == 0, counts
    else:
        assert counts["pool Function"] > 0 and counts["upsample Function"] == 0, counts
    with _routing_counts() as counts, torch.no_grad():
        loss()
    assert counts["pool Function"] == 0 and counts["upsample Function"] == 0, counts


def test_deterministic_cudnn_sets_and_restores_the_flags():
    saved = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = False
        with deterministic_cudnn():
            assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.deterministic
        with pytest.raises(ValueError), deterministic_cudnn():
            raise ValueError
        assert not torch.backends.cudnn.deterministic
    finally:
        torch.backends.cudnn.deterministic = saved


def test_recorded_calls_are_checked_at_their_full_shape():
    from ted_spad_tpu_torch import chip_probes

    seen, logged = {}, []
    x = torch.randn((3, 2, 5, 7, 6)).contiguous(memory_format=torch.channels_last_3d).requires_grad_(True)
    y = torch.randn((3, 2, 5, 4), dtype=torch.float64).requires_grad_(True)
    with chip_probes.recorded_backward_calls(seen):
        for out in (max_pool3d(x, (2, 3, 3), (2, 2, 2)), layers.resize_bilinear(y)):
            out.backward(torch.randn_like(out))
    assert sorted(seen, key=str) == [
        ("K5", (3, 2, 5, 7, 6), (2, 3, 3), (2, 2, 2), (0, 0, 0), "float32", True, (24, 1, 12, 4, 2)),
        ("K6", (3, 2, 5, 4), "float32", False, (160, 80, 8, 1)),
    ]
    assert chip_probes.check_recorded(torch.device("cpu"), seen, logged.append) == {"K5": (1, 0.0), "K6": (1, 0.0)}
    assert len(logged) == 2 and all("bit-equal" in line for line in logged)
    with pytest.raises(AssertionError, match="x3"):
        layers.resize_bilinear(y, 3)
