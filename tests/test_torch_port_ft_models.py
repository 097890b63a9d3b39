"""Port parity of the ft architectures beside I3Res50: InceptionI3d (``"i3d"``),
R3D18 (``"r3d_18"``) and MViTv2-S (``"mvitv2"``), against the JAX modules in float32
on the CPU.

Weights: the port's seeded init written out by ``state_dict_to_flax``, checked key by
key and shape by shape against the JAX module's variables tree and perturbed leaf by
leaf from a numpy seed (``test_torch_port_fullwidth.bridged``), so that BatchNorm
statistics, zero-initialised rel-pos tables and the class token differ from their
defaults; both sides get them, the port through ``load_jax_variables``. Tolerance 1e-4
of the output's largest magnitude (``test_torch_port_fullwidth.assert_close``).

InceptionI3d runs at full width: its trunk on a small clip, its pooled feature and
logits at the smallest clip the (2, 7, 7) pooling admits, 9x193x193. R3D18 runs at
full width on 8x32x32 clips, MViTv2-S at the tiny configuration of tests/test_mvit.py
on 8x64x64 clips."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_fullwidth import assert_close, bridged
from ted_spad_tpu.models.i3d import InceptionI3d as JaxInceptionI3d
from ted_spad_tpu.models.layers import max_pool_same as jax_max_pool_same
from ted_spad_tpu.models.layers import tf_same_pads as jax_tf_same_pads
from ted_spad_tpu.models.mvit import MViTv2Config as JaxMViTv2Config
from ted_spad_tpu.models.mvit import MViTv2S as JaxMViTv2S
from ted_spad_tpu.models.r3d import R3D18 as JaxR3D18
from ted_spad_tpu_torch.models import FT_FEATURE_DIMS, load_ft_model
from ted_spad_tpu_torch.models.layers import max_pool_same, tf_same_pads
from ted_spad_tpu_torch.models.mvit import MViTv2Config, MViTv2S
from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables, state_dict_to_flax

torch.set_num_threads(1)

TINY_MVIT = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), heads=(1, 2, 4, 8),
                 kv_strides=((1, 4, 4), (1, 2, 2), (1, 1, 1), (1, 1, 1)))


def _clips(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _both(module, jmodel, x: np.ndarray, seed: int, method=None):
    """The JAX module's and the port's outputs on ``x`` from the same bridged weights."""
    variables = bridged(module, jmodel, jnp.asarray(x), seed=seed)
    ref = jax.jit(functools.partial(jmodel.apply, train=False, method=method))(variables, x)
    load_jax_variables(module, variables)
    with torch.inference_mode():
        ours = getattr(module, method or "forward")(_ncdhw(x))
    return ours, ref


@pytest.mark.parametrize("size,kernel,stride", [(7, 3, 2), (8, 3, 2), (16, 7, 2), (5, 2, 2), (9, 1, 1),
                                                (112, 3, 1), (3, 7, 2)])
def test_tf_same_pads_match_jax(size, kernel, stride):
    assert tf_same_pads(size, kernel, stride) == jax_tf_same_pads(size, kernel, stride)


def test_max_pool_same_pads_with_the_lowest_value():
    """Asymmetric TF-SAME padding with finfo.min, not 0: all-negative inputs keep their
    maxima at the edges."""
    x = -_clips((2, 5, 7, 9, 3), 0) - 1.0
    for window, strides in (((3, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 2, 2)), ((2, 2, 2), (2, 2, 2))):
        ref = np.asarray(jax_max_pool_same(jnp.asarray(x), window, strides))
        ours = max_pool_same(_ncdhw(x), window, strides).permute(0, 2, 3, 4, 1).numpy()
        np.testing.assert_array_equal(ours, ref)


def test_i3d_trunk_matches_jax():
    ft = load_ft_model("i3d", num_classes=7, dtype="float32", device="cpu")
    x = _clips((2, 8, 32, 40, 3), 1)
    ours, ref = _both(ft, JaxInceptionI3d(num_classes=7, dtype=jnp.float32), x, seed=0,
                      method="trunk")
    assert ours.shape == (2, 1024, 1, 1, 2)
    assert_close(ours.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref))


def test_i3d_features_and_logits_match_jax_at_the_smallest_pooled_clip():
    ft = load_ft_model("i3d", num_classes=7, dtype="float32", device="cpu")
    x = _clips((1, 9, 193, 193, 3), 2)
    (logits, feat), (ref_logits, ref_feat) = _both(
        ft, JaxInceptionI3d(num_classes=7, dtype=jnp.float32), x, seed=1)
    assert feat.shape == (1, FT_FEATURE_DIMS["i3d"]) and logits.shape == (1, 7)
    assert_close(feat.numpy(), np.asarray(ref_feat))
    assert_close(logits.numpy(), np.asarray(ref_logits))
    with pytest.raises(ValueError, match="9x193x193"):
        ft.extract_features(torch.zeros(1, 3, 8, 193, 193))


def test_r3d18_matches_jax():
    ft = load_ft_model("r3d_18", num_classes=5, dtype="float32", device="cpu")
    x = _clips((2, 8, 32, 32, 3), 3)
    (logits, feat), (ref_logits, ref_feat) = _both(ft, JaxR3D18(num_classes=5, dtype=jnp.float32),
                                                   x, seed=2)
    assert feat.shape == (2, FT_FEATURE_DIMS["r3d_18"]) and logits.shape == (2, 5)
    assert_close(feat.numpy(), np.asarray(ref_feat))
    assert_close(logits.numpy(), np.asarray(ref_logits))


def test_mvitv2_matches_jax():
    ft = MViTv2S(6, MViTv2Config(**TINY_MVIT), clip_shape=(8, 64, 64),
                 generator=torch.Generator().manual_seed(0)).eval()
    jmodel = JaxMViTv2S(num_classes=6, config=JaxMViTv2Config(**TINY_MVIT), dtype=jnp.float32)
    x = _clips((2, 8, 64, 64, 3), 4)
    (logits, feat), (ref_logits, ref_feat) = _both(ft, jmodel, x, seed=3)
    assert feat.shape == (2, 128) and logits.shape == (2, 6)
    assert_close(feat.numpy(), np.asarray(ref_feat))
    assert_close(logits.numpy(), np.asarray(ref_logits))
    with pytest.raises(ValueError, match="token grid"):
        ft.extract_features(torch.zeros(1, 3, 8, 32, 32))


def test_full_width_mvitv2_variables_match_jax():
    """MViTv2-S at its published widths and a 16x224x224 clip: the variables tree the
    port writes is the JAX module's, key by key and shape by shape (abstract init)."""
    ft = load_ft_model("mvitv2", dtype="float32", device="cpu")
    shapes = jax.eval_shape(functools.partial(JaxMViTv2S(dtype=jnp.float32).init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 16, 224, 224, 3)))
    want = jax.tree_util.tree_map(lambda s: s.shape, shapes)
    got = jax.tree_util.tree_map(np.shape, state_dict_to_flax(ft))
    assert got == want


@pytest.mark.parametrize("arch", ["i3d", "r3d_18", "mvitv2"])
def test_state_dict_to_flax_round_trip(arch):
    """A module's weights through state_dict_to_flax and load_jax_variables into a
    differently seeded module come back equal, key by key."""
    kw = dict(num_classes=3, dtype="float32", device="cpu", clip_shape=(8, 32, 32))
    a, b = load_ft_model(arch, seed=1, **kw), load_ft_model(arch, seed=2, **kw)
    load_jax_variables(b, state_dict_to_flax(a))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        torch.testing.assert_close(sb[key], sa[key], rtol=0, atol=0)


def test_load_ft_model_builds_every_architecture():
    for arch, dim in FT_FEATURE_DIMS.items():
        ft = load_ft_model(arch, dtype="float32", device="cpu", tiny=arch == "largei3d",
                           clip_shape=(8, 32, 32))
        assert hasattr(ft, "extract_features"), arch
    with pytest.raises(ValueError, match="invalid for ft_model"):
        load_ft_model("resnet", device="cpu")
    with pytest.raises(ValueError, match="tiny"):
        load_ft_model("i3d", tiny=True, device="cpu")
