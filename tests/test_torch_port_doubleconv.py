"""Port parity for the fused DoubleConv (ted_spad_tpu_torch/ops/doubleconv.py): the
plain version against the JAX reference and the Pallas kernel in interpret mode,
BN folding with and without the conv bias, the port's DoubleConv module against a
flax DoubleConv in eval mode, and the wrapper's input checks.

Inputs come from numpy seeds; both sides compute in float32 on the CPU unless a test
says otherwise, and each tolerance is stated where it is used."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ted_spad_tpu.models.unet import DoubleConv as JaxDoubleConv
from ted_spad_tpu.ops import pallas_doubleconv as jdc
from ted_spad_tpu_torch.models.unet import DoubleConv
from ted_spad_tpu_torch.ops.doubleconv import double_conv_reference, fold_bn, fused_double_conv
from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables

torch.set_num_threads(1)


def _operands(seed, n, h, w, cin, cmid, cout, b1=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32) * 0.1
    w1 = rng.standard_normal((3, 3, cin, cmid)).astype(np.float32) * 0.05
    b1 = rng.standard_normal(cmid).astype(np.float32) * 0.1 if b1 is None else b1
    w2 = rng.standard_normal((3, 3, cmid, cout)).astype(np.float32) * 0.05
    b2 = rng.standard_normal(cout).astype(np.float32) * 0.1
    return x, w1, b1, w2, b2


def _port(args, dtype=torch.float32):
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args)
    return double_conv_reference(x.to(dtype), w1.to(dtype), b1, w2.to(dtype), b2)


# The shapes of tests/test_pallas_doubleconv.py (one frame), and its halo case: b1 = 5
# makes relu(conv1(zero padding) + b1) very non-zero, which conv2 must not see.
CASES = {
    "112-cluster-128": ((1, 56, 56, 128, 64, 64), None, 28),
    "112-cluster-320": ((1, 28, 56, 320, 64, 64), None, 14),
    "112-cluster-192": ((1, 56, 56, 192, 64, 64), None, 28),
    "halo-b1-5": ((1, 28, 28, 16, 8, 8), np.full(8, 5.0, np.float32), 14),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_reference_and_pallas_interpret(case):
    """f32: relative to max|ref| within 1e-5 (float32 summation order only)."""
    shape, b1, th = CASES[case]
    args = _operands(3, *shape, b1=b1)
    ours = _port(args).numpy()
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(jdc.double_conv_reference(*jargs))
    kern = np.asarray(jdc.fused_double_conv(*jargs, th=th, interpret=True))
    scale = np.abs(ref).max()
    assert ours.shape == ref.shape == kern.shape and scale > 0
    assert np.abs(ours - ref).max() <= 1e-5 * scale
    assert np.abs(ours - kern).max() <= 1e-5 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_ragged_shape_matches_jax_reference(dtype):
    """A ragged 13x17 frame with 24 -> 16 -> 8 channels (the Pallas kernel needs H % th
    == 0; the port's kernel does not). f32: 1e-5 of max|ref| (summation order).
    bf16: inputs and weights rounded to bf16 on both sides, conv1 result rounded to
    bf16 between the convs as the JAX reference does; 2**-6 of max|ref| allows a
    summation-order flip in the rounding of a conv1 value and of the output (one
    bf16 ulp is 2**-8 to 2**-7 of a value)."""
    args = _operands(4, 2, 13, 17, 24, 16, 8)
    torch_dtype = getattr(torch, dtype)
    ours = _port(args, torch_dtype).float().numpy()
    x, w1, b1, w2, b2 = (jnp.asarray(a) for a in args)
    jd = getattr(jnp, dtype)
    ref = np.asarray(jdc.double_conv_reference(x.astype(jd), w1.astype(jd), b1,
                                               w2.astype(jd), b2).astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    assert ours.shape == ref.shape == (2, 13, 17, 8)
    assert np.abs(ours - ref).max() <= tol * np.abs(ref).max()


def _bn_params(rng, c):
    return (rng.uniform(0.5, 1.5, c).astype(np.float32), rng.standard_normal(c).astype(np.float32),
            rng.standard_normal(c).astype(np.float32) * 0.1,
            rng.uniform(0.5, 2.0, c).astype(np.float32))


@pytest.mark.parametrize("with_bias", [False, True])
def test_fold_bn_matches_jax_and_folds_the_conv_bias(with_bias):
    """Without a conv bias the port's fold equals JAX ``fold_bn`` (f32, 1e-6); with one,
    conv(x, w*) + b* equals BN(conv(x, w) + bias) in eval mode (f32, 1e-5)."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 3, 6, 5)).astype(np.float32) * 0.1
    gamma, beta, mean, var = _bn_params(rng, 5)
    bias = rng.standard_normal(5).astype(np.float32) if with_bias else None
    t = torch.from_numpy
    wf, bf = fold_bn(t(w), t(gamma), t(beta), t(mean), t(var),
                     bias=None if bias is None else t(bias))
    if not with_bias:
        jw, jb = jdc.fold_bn(w, gamma, beta, mean, var)
        np.testing.assert_allclose(wf.numpy(), jw, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(bf.numpy(), jb, rtol=1e-6, atol=1e-6)
    x = torch.from_numpy(rng.standard_normal((1, 6, 9, 11)).astype(np.float32))
    conv = torch.nn.functional.conv2d
    raw = conv(x, t(w).permute(3, 2, 0, 1), None if bias is None else t(bias), padding=1)
    want = (raw - t(mean)[:, None, None]) * (t(gamma) / torch.sqrt(t(var) + 1e-5))[:, None, None] \
        + t(beta)[:, None, None]
    got = conv(x, wf.permute(3, 2, 0, 1), bf, padding=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        noise = 0.05 * rng.standard_normal(x.shape) if x.ndim == 1 else 0.0
        return (x * rng.uniform(0.8, 1.2, x.shape) + noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, variables))


@pytest.mark.parametrize("cin,mid,features", [(5, None, 12), (20, 16, 8)])
def test_double_conv_module_matches_flax_eval(cin, mid, features):
    """The port's DoubleConv (conv bias + BN folded, one fused call) against the flax
    DoubleConv in eval mode (conv + bias -> BN -> ReLU, twice), weights through the
    bridge; f32, 1e-5 relative + 1e-5 absolute (folding reorders the float32 ops)."""
    jmod = JaxDoubleConv(features, mid, dtype=jnp.float32)
    x = np.random.default_rng(6).standard_normal((2, 10, 14, cin)).astype(np.float32)
    variables = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 7)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    ours_mod = DoubleConv(cin, features, mid, generator=torch.Generator().manual_seed(0)).eval()
    load_jax_variables(ours_mod, variables)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        ours = ours_mod(xt)
        plain = ours_mod(xt, use_kernel=False)
    assert ours.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ours, plain, rtol=0, atol=0)


def test_wrapper_checks_and_counts_only_launches():
    """Shapes, dtypes and layouts the kernel does not take raise on every device; on
    the CPU the wrapper runs the plain version and counts no launch."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _operands(8, 1, 6, 7, 4, 8, 3))
    before = fused_double_conv.launches
    torch.testing.assert_close(fused_double_conv(x, w1, b1, w2, b2),
                               double_conv_reference(x, w1, b1, w2, b2), rtol=0, atol=0)
    assert fused_double_conv.launches == before
    with pytest.raises(ValueError, match="contiguous"):
        fused_double_conv(x.transpose(1, 2).contiguous().transpose(1, 2), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w2 has shape"):
        fused_double_conv(x, w1, b1, w2[:, :, :4], b2)
    with pytest.raises(ValueError, match="must match"):
        fused_double_conv(x, w1.bfloat16(), b1, w2, b2)
    with pytest.raises(ValueError, match="float32"):
        fused_double_conv(x, w1, b1.double(), w2, b2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_double_conv(x.half(), w1.half(), b1, w2.half(), b2)
