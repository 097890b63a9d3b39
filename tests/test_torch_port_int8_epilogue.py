"""K4's fused W8A8 epilogue (``ted_spad_tpu_torch.ops.int8conv``: ``Epilogue``,
``int8_conv_reference``) on the CPU, for each epilogue form the int8 path runs
(``chip_probes.K4_FORMS``) at ragged shapes, in float32 and bfloat16:

- the plain version equals the same torch operations written out here
  (``int8_conv_int32`` -> dequant -> bias -> BatchNorm -> residual -> ReLU -> ``q8``);
- in float32 it equals the JAX package's op-by-op chain (``_Quantizer.conv`` ->
  conv bias -> ``_affine_relu`` -> residual -> ReLU -> ``q8``, not jitted), as
  test_torch_port_quant.py holds the dequant alone;
- a numpy emulation of the kernel's arithmetic (one float32 operation at a time,
  bf16 round-to-nearest-even by bit manipulation, the host's float32 of the double
  1 / s_out) equals the plain version: the CPU's stand-in for the card, which an
  emulation that contracts the BatchNorm's multiply-add into one rounding fails.

Tolerance: none; every comparison is bit for bit (int8 codes equal, float values equal)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ted_spad_tpu.ops.quant_unetpp as jqu
from ted_spad_tpu.ops.fast_unetpp import _bn_affine as jax_bn_affine
from ted_spad_tpu_torch.chip_probes import K4_FORMS, k4_epilogue
from ted_spad_tpu_torch.ops import int8conv

torch.set_num_threads(1)

ACT_SCALE = 0.037
# (x shape, kernel shape, strides, pads, lhs dilation): odd Cout, Cout below 8, a Cout
# that is no multiple of 64 at stride 2, a 3D conv, the up2_int8 lhs-dilated 4x4 form.
SHAPES = {
    "odd Cout 5": ((2, 7, 9, 16), (3, 3, 16, 5), (1, 1), ((1, 1), (1, 1)), None),
    "Cout 3": ((1, 6, 5, 32), (3, 3, 32, 3), (1, 1), ((1, 1), (1, 1)), None),
    "Cout 72 stride 2": ((1, 9, 8, 32), (3, 3, 32, 72), (2, 2), ((1, 1), (1, 1)), None),
    "3D (1,3,3) stride 2": ((1, 2, 7, 7, 16), (1, 3, 3, 16, 24), (1, 2, 2),
                            ((0, 0), (1, 1), (1, 1)), None),
    "up2 4x4 dilated": ((2, 4, 5, 16), (4, 4, 16, 8), (1, 1), ((2, 2), (2, 2)), (2, 2)),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(shape: str, form: str, dtype: torch.dtype):
    """Seeded (x, float kernel, weight, conv kwargs, epilogue) of one case."""
    xs, ws, strides, pads, dil = SHAPES[shape]
    rng = np.random.default_rng(len(shape) * 31 + len(form))
    x = torch.from_numpy(rng.integers(-127, 128, xs, dtype=np.int8))
    w = torch.from_numpy(rng.standard_normal(ws).astype(np.float32))
    weight = int8conv.int8_weight(w)
    kw = dict(strides=strides, padding=pads, lhs_dilation=dil)
    out_shape = int8conv.conv_out_shape(xs, ws, **kw)
    ep = k4_epilogue(form, weight, out_shape, dtype, "cpu", seed=len(form), act_scale=ACT_SCALE)
    return x, w, weight, kw, ep


def _written_out(x, weight, kw, ep, dtype):
    """The epilogue's torch operations, one by one."""
    acc = int8conv.int8_conv_int32(x, weight.codes, **kw)
    y = (acc.to(torch.float32) * (weight.scale * ACT_SCALE)).to(dtype)
    if ep.bias is not None:
        y = y + ep.bias
    if ep.bn is not None:
        y = y * ep.bn[0]
        y = y + ep.bn[1]
    if ep.residual is not None:
        r = ep.residual
        if ep.residual_scale is not None:
            r = (r.to(torch.float32) * ep.residual_scale).to(dtype)
        y = y + r
    if ep.relu:
        y = torch.relu(y)
    if ep.out_scale is None:
        return y
    return torch.clamp(torch.round(y.to(torch.float32) * (1.0 / ep.out_scale)), -127,
                       127).to(torch.int8)


CASES = [(s, f) for s in SHAPES for f in K4_FORMS]


@pytest.mark.parametrize("shape,form", CASES)
def test_epilogue_form_is_the_written_out_ops(shape, form):
    for dtype in DTYPES.values():
        x, _, weight, kw, ep = _case(shape, form, dtype)
        assert ep.form() == form
        got = int8conv.int8_conv(x, weight, ACT_SCALE, out_dtype=dtype, epilogue=ep, **kw)
        want = _written_out(x, weight, kw, ep, dtype)
        assert got.dtype == (torch.int8 if ep.out_scale is not None else dtype)
        assert got.shape == want.shape and got.is_contiguous()
        assert torch.equal(got, want), (shape, form, dtype)
        if ep.out_scale is not None:  # the codes use their range, and some clamp
            assert int((got != 0).sum()) > got.numel() // 4


@pytest.mark.parametrize("shape,form", CASES)
def test_epilogue_form_matches_jax_op_by_op(shape, form):
    """float32: the plain version against the JAX package's quantizer, op by op."""
    x, w, weight, kw, ep = _case(shape, form, torch.float32)
    rng = np.random.default_rng(7)
    cout = w.shape[-1]
    qz = jqu._Quantizer("run", {"out": ep.out_scale or 1.0}, jnp.float32)
    y = qz.conv(jqu.QT(jnp.asarray(x.numpy()), ACT_SCALE), jnp.asarray(w.numpy()),
                strides=kw["strides"], padding=list(kw["padding"]),
                lhs_dilation=kw["lhs_dilation"])
    if ep.bias is not None:
        y = y + jnp.asarray(ep.bias.numpy()).astype(y.dtype)
    if ep.bn is not None:
        # A BatchNorm whose folded (scale, bias) JAX computes; the port gets the same pair.
        p_bn = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, cout).astype(np.float32)),
                "bias": jnp.asarray(ep.bn[1].numpy())}
        s_bn = {"mean": jnp.asarray(rng.normal(0, 0.1, cout).astype(np.float32)),
                "var": jnp.asarray(rng.uniform(0.5, 2.0, cout).astype(np.float32))}
        sc, bi = jax_bn_affine(p_bn, s_bn)
        ep = ep._replace(bn=(torch.from_numpy(np.array(sc)), torch.from_numpy(np.array(bi))))
        y = jqu._affine_relu(y, p_bn, s_bn, jnp.float32, relu=False)
    if ep.residual is not None:
        if ep.residual_scale is not None:
            y = y + qz.dequant(jqu.QT(jnp.asarray(ep.residual.numpy()), ep.residual_scale))
        else:
            y = y + jnp.asarray(ep.residual.numpy())
    if ep.relu:
        y = jax.nn.relu(y)
    if ep.out_scale is not None:
        y = qz.q8("out", y).data
    got = int8conv.int8_conv(x, weight, ACT_SCALE, out_dtype=torch.float32, epilogue=ep, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(y))


def bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 (ties to even), as float32, by bit manipulation."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def emulate_k4(acc: np.ndarray, scale: np.ndarray, ep, dtype, contract: bool = False):
    """K4's epilogue arithmetic on int32 sums ``acc``, one float32 operation at a time,
    each rounded to the compute type, as csrc/int8conv.cu writes it with __fmul_rn /
    __fadd_rn. ``contract``: the BatchNorm's multiply-add with one rounding (what an
    FMA would give), which the kernel must not do."""
    rc = bf16_round if dtype == torch.bfloat16 else (lambda v: v)
    f32 = np.float32
    vec = lambda t: rc(t.float().numpy())  # noqa: E731  (operands already in dtype)
    v = rc(acc.astype(f32) * scale)
    if ep.bias is not None:
        v = rc(v + vec(ep.bias))
    if ep.bn is not None:
        bs, bb = vec(ep.bn[0]), vec(ep.bn[1])
        if contract:
            v = rc((v.astype(np.float64) * bs + bb).astype(f32))
        else:
            v = rc(rc(v * bs) + bb)
    if ep.residual is not None:
        if ep.residual_scale is not None:
            r = rc(ep.residual.numpy().astype(f32) * f32(ep.residual_scale))
        else:
            r = vec(ep.residual)
        v = rc(v + r)
    if ep.relu:
        v = np.where(v < 0, f32(0), v)
    if ep.out_scale is None:
        return v
    inv = f32(1.0 / ep.out_scale)  # the host's float32 of the double 1 / s
    return np.clip(np.rint(v * inv), -127, 127).astype(np.int8)


@pytest.mark.parametrize("shape,form", CASES)
def test_kernel_arithmetic_emulation_matches_plain_version(shape, form):
    for dtype in DTYPES.values():
        x, _, weight, kw, ep = _case(shape, form, dtype)
        acc = int8conv.int8_conv_int32(x, weight.codes, **kw).numpy()
        scale = int8conv.channel_scale(ACT_SCALE, weight.scale).numpy()
        got = emulate_k4(acc, scale, ep, dtype)
        want = int8conv.int8_conv_reference(x, weight, ACT_SCALE, out_dtype=dtype, epilogue=ep,
                                            **kw)
        np.testing.assert_array_equal(got, want.float().numpy() if want.is_floating_point()
                                      else want.numpy(), err_msg=f"{shape} {form} {dtype}")


def test_emulation_tells_a_contracted_multiply_add_apart():
    """The emulation has the power to catch an FMA in the float32 BatchNorm: contracted,
    it differs from the plain version."""
    x, _, weight, kw, ep = _case("Cout 72 stride 2", "bn", torch.float32)
    acc = int8conv.int8_conv_int32(x, weight.codes, **kw).numpy()
    scale = int8conv.channel_scale(ACT_SCALE, weight.scale).numpy()
    want = int8conv.int8_conv_reference(x, weight, ACT_SCALE, out_dtype=torch.float32,
                                        epilogue=ep, **kw).numpy()
    np.testing.assert_array_equal(emulate_k4(acc, scale, ep, torch.float32), want)
    assert (emulate_k4(acc, scale, ep, torch.float32, contract=True) != want).any()


def test_int8_conv_refuses_a_wrong_epilogue():
    x, _, weight, kw, ep = _case("odd Cout 5", "bn+res+relu->int8", torch.float32)
    with pytest.raises(ValueError, match="residual"):
        int8conv.int8_conv(x, weight, ACT_SCALE, out_dtype=torch.float32,
                           epilogue=ep._replace(residual=ep.residual[:1]), **kw)
    with pytest.raises(ValueError, match="bfloat16"):  # float32 operands, a bf16 conv
        int8conv.int8_conv(x, weight, ACT_SCALE, out_dtype=torch.bfloat16, epilogue=ep, **kw)
    with pytest.raises(ValueError, match="bn"):
        int8conv.int8_conv(x, weight, ACT_SCALE, out_dtype=torch.float32,
                           epilogue=ep._replace(bn=(ep.bn[0][:2], ep.bn[1])), **kw)
    with pytest.raises(ValueError, match="residual_scale"):
        int8conv.int8_conv(x, weight, ACT_SCALE, out_dtype=torch.float32,
                           epilogue=ep._replace(residual=None, residual_scale=0.5), **kw)
