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
- Emulations of the kernels' own loops (one input element at a time, its windows or
  taps visited in the kernel's order, numpy scalars rounding each operation as the
  card does) bit-equal to the plain versions: the order the two share is the kernels'.
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


def _emulate_k5(grad, idx, shape, window, strides, padding, acc_type):
    """csrc/maxpool3d.cu's loop on the CPU: per input element, the windows that hold it
    in ascending (od, oh, ow) order, grad_out added where the argmax names it, in
    ``acc_type`` scalars."""
    b, c, d, h, w = shape
    out = np.zeros(shape, acc_type)
    od, oh, ow = grad.shape[2:]

    def window_range(i, pad, k, s, n):
        first = i + pad - k + 1
        lo = 0 if first <= 0 else (first + s - 1) // s
        return lo, min((i + pad) // s, n - 1)

    for bi, ci, zd, zh, zw in np.ndindex(*shape):
        (d0, d1), (h0, h1), (w0, w1) = (window_range(i, p, k, s, n) for i, p, k, s, n in zip(
            (zd, zh, zw), padding, window, strides, (od, oh, ow)))
        target = (zd * h + zh) * w + zw
        acc = acc_type(0)
        for a in range(d0, d1 + 1):
            for e in range(h0, h1 + 1):
                for f in range(w0, w1 + 1):
                    if idx[bi, ci, a, e, f] == target:
                        acc = acc_type(acc + acc_type(grad[bi, ci, a, e, f]))
        out[bi, ci, zd, zh, zw] = acc
    return out


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_k5_loop_emulation_is_bit_equal_to_plain(pool):
    shape, window, strides, kind = POOLS[pool]
    padding = tuple(k // 2 for k in window) if kind == "mvit" else (0, 0, 0)
    g = torch.Generator().manual_seed(5)
    x = torch.randint(-2, 3, shape, generator=g).float()
    out, idx = F.max_pool3d(x, window, strides, padding, return_indices=True)
    grad = torch.randn(out.shape, generator=g)
    want = max_pool3d_backward_reference(grad, idx, shape, window, strides, padding)
    got = _emulate_k5(grad.numpy(), idx.numpy(), shape, window, strides, padding, np.float32)
    np.testing.assert_array_equal(got, want.numpy())


def _emulate_k6(grad, shape, scale, t):
    """csrc/upsample_bilinear.cu's loop on the CPU in numpy scalars of type ``t``: per
    input pixel, the outputs of each axis that read it (candidates [s i - s - 1, s i +
    3 s - 2], ascending), the x sum inside the y sum, each product and sum rounded."""
    n, c, h, w = shape
    oh, ow = h * scale, w * scale
    sy = t(h - 1) / t(oh - 1) if oh > 1 else t(0)
    sx = t(w - 1) / t(ow - 1) if ow > 1 else t(0)

    def tap(o, i, n_in, s):
        src = t(s * t(o))
        i0 = int(src)
        i1 = i0 + (1 if i0 < n_in - 1 else 0)
        if i0 != i and i1 != i:
            return None
        lam1 = t(src - t(i0))
        lam0 = t(t(1) - lam1)
        return t((lam0 if i0 == i else t(0)) + (lam1 if i1 == i else t(0)))

    out = np.zeros(shape, t)
    for b, ch, y, x in np.ndindex(*shape):
        acc = t(0)
        for oy in range(max(0, scale * y - scale - 1), min(oh - 1, scale * y + 3 * scale - 2) + 1):
            wy = tap(oy, y, h, sy)
            if wy is None:
                continue
            row = t(0)
            for ox in range(max(0, scale * x - scale - 1), min(ow - 1, scale * x + 3 * scale - 2) + 1):
                wx = tap(ox, x, w, sx)
                if wx is not None:
                    row = t(row + t(wx * t(grad[b, ch, oy, ox])))
            acc = t(acc + t(wy * row))
        out[b, ch, y, x] = acc
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (5, 4), (9, 7)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_k6_loop_emulation_is_bit_equal_to_plain(hw, dtype):
    h, w = hw
    grad = torch.randn((1, 2, 2 * h, 2 * w), generator=torch.Generator().manual_seed(7), dtype=dtype)
    want = upsample_bilinear_backward_reference(grad, (1, 2, h, w))
    t = np.float32 if dtype == torch.float32 else np.float64
    np.testing.assert_array_equal(_emulate_k6(grad.numpy(), (1, 2, h, w), 2, t), want.numpy())


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
