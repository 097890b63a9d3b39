"""Port parity: ted_spad_tpu_torch models (fa UNet++, ft I3Res50, MGFN) against the
JAX modules, with the same weights carried over by the bridge
(ted_spad_tpu_torch/utils/jax_weights.py), and the bridge against the repo's
torch->flax converter.

Weights are the JAX init, perturbed from a numpy seed so that every leaf (BN
statistics included) differs from its default and a wrong mapping shows. Both
sides compute in float32 on the CPU; the tolerances allow float32 rounding
through the networks' depth and are stated per test."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ted_spad_tpu.config.params import MGFNParams as JaxMGFNParams
from ted_spad_tpu.models import load_fa_model as jax_load_fa
from ted_spad_tpu.models import load_ft_model as jax_load_ft
from ted_spad_tpu.models import load_mgfn_model as jax_load_mgfn
from ted_spad_tpu.models.i3res50 import WrapperI3D as JaxWrapperI3D
from ted_spad_tpu.stages.anomaly_detection import make_score_fn as jax_make_score_fn
from ted_spad_tpu.utils.torch_convert import convert_i3res50
from ted_spad_tpu_torch.config.params import MGFNParams
from ted_spad_tpu_torch.data.features import padded_test_batch
from ted_spad_tpu_torch.models import load_fa_model, load_ft_model, load_mgfn_model
from ted_spad_tpu_torch.stages.anomaly_detection import make_score_fn
from ted_spad_tpu_torch.utils.jax_weights import (
    FT_HEADS, flax_to_state_dict, load_jax_variables, load_npz_variables,
)

torch.set_num_threads(1)


def perturbed(variables, seed: int):
    """numpy copy of a flax variables tree with every leaf moved off its init."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x * rng.uniform(0.8, 1.2, x.shape) + 0.05 * rng.standard_normal(x.shape)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, variables))


def test_fa_tiny_matches_jax():
    """UNet++ eval forward; tolerance 1e-4 rel + 1e-4 abs (f32, ~25 convs deep)."""
    model, variables = jax_load_fa(image_size=(32, 32), dtype="float32", tiny=True)
    variables = perturbed(variables, 0)
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))

    fa = load_jax_variables(load_fa_model(tiny=True, dtype="float32", device="cpu"), variables)
    with torch.inference_mode():
        ours = fa(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_ft_tiny_matches_jax_extract_features():
    """I3Res50 extract_features; tolerance 1e-4 rel + 1e-4 abs (f32, 13 convs deep)."""
    model, variables = jax_load_ft(clip_shape=(8, 32, 32), dtype="float32", tiny=True)
    variables = perturbed(variables, 2)
    x = np.random.default_rng(3).uniform(0, 1, (2, 8, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False, method="extract_features"))

    ft = load_jax_variables(load_ft_model(tiny=True, dtype="float32", device="cpu"), variables,
                            skip=FT_HEADS)
    with torch.inference_mode():
        ours = ft.extract_features(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).numpy()
    assert ours.shape == ref.shape == (2, 256)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


MGFN_SMALL = dict(dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16, feature_size=32)


def test_mgfn_matches_jax_with_mask_and_bucket_padding():
    """Scores from a bucket-padded, masked batch: JAX vs port within 1e-5 (sigmoid
    outputs in [0, 1], f32); the port's padded scores equal its native-length ones
    within 1e-6 (the mask makes padding exact up to float32 summation order)."""
    ncrops, t = 2, 10
    jp = JaxMGFNParams.for_dataset("UCF").replace(**MGFN_SMALL)
    jmodel, variables = jax_load_mgfn(jp, ncrops=ncrops)
    variables = perturbed(variables, 4)
    feats = np.random.default_rng(5).standard_normal((t, ncrops, 33)).astype(np.float32)
    video, mask, _ = padded_test_batch(feats, multiple=16)
    ref = np.asarray(jax_make_score_fn(jmodel)(variables, video, mask))

    model = load_jax_variables(
        load_mgfn_model(MGFNParams.for_dataset("UCF").replace(**MGFN_SMALL), device="cpu"),
        variables)
    score_fn = make_score_fn(model, device="cpu")
    ours = score_fn(video, mask).numpy()
    assert ours.shape == ref.shape == (1, 16)
    np.testing.assert_allclose(ours[:, :t], ref[:, :t], atol=1e-5, rtol=0)

    native = score_fn(video[:, :, :t], mask[:, :t]).numpy()
    np.testing.assert_allclose(ours[:, :t], native, atol=1e-6, rtol=0)
    with torch.inference_mode():
        unmasked = model(torch.from_numpy(video[:, :, :t]))[-1][..., 0].numpy()
    np.testing.assert_allclose(native, unmasked, atol=1e-6, rtol=0)


def test_mgfn_msnsd_outputs_match_jax():
    """The full inference tuple (top-k magnitude selection included) at native length."""
    jp = JaxMGFNParams.for_dataset("UCF").replace(**MGFN_SMALL)
    jmodel, variables = jax_load_mgfn(jp, ncrops=1)
    variables = perturbed(variables, 6)
    video = np.random.default_rng(7).standard_normal((2, 1, 12, 33)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(video), train=False, inference=True)
    model = load_jax_variables(
        load_mgfn_model(MGFNParams.for_dataset("UCF").replace(**MGFN_SMALL), device="cpu"),
        variables)
    with torch.inference_mode():
        ours = model(torch.from_numpy(video))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


def _full_i3res50_variables(seed: int):
    """Full-width WrapperI3D variables (shapes from an abstract init, no compile),
    filled with seeded numpy values."""
    model = JaxWrapperI3D(num_classes=400, dtype=jnp.float32)
    shapes = jax.eval_shape(functools.partial(model.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 32, 32, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _to_resnet3d_names(key: str) -> str:
    """Port ft key -> pytorch-resnet3d name, as convert_i3res50 reads them."""
    key = key.removeprefix("i3d.")
    parts = key.split(".")
    if parts[0] == "stem":
        mod = {"conv": "conv1", "bn": "bn1"}[parts[1]]
        return ".".join([mod] + parts[2:])
    _, layer, block = parts[0].split("_")  # blocks_layer{L}_{B}
    prefix = f"{layer}.{block}"
    if parts[1] == "downsample":
        return ".".join([prefix, "downsample", {"conv": "0", "bn": "1"}[parts[2]]] + parts[3:])
    conv_i = parts[1][-1]
    return ".".join([prefix, {"conv": f"conv{conv_i}", "bn": f"bn{conv_i}"}[parts[2]]] + parts[3:])


def test_bridge_is_the_inverse_of_torch_convert():
    """JAX I3Res50 variables -> bridge -> port state_dict -> pytorch-resnet3d names
    -> convert_i3res50 gives back the original tree, exactly. The backbone only:
    the classifier and the MLP head (FT_HEADS) are not pytorch-resnet3d's."""
    variables = _full_i3res50_variables(8)
    ft = load_jax_variables(load_ft_model(dtype="float32", device="cpu"), variables, skip=FT_HEADS)
    heads = tuple(h + "." for h in FT_HEADS)
    sd = {_to_resnet3d_names(k): v for k, v in ft.state_dict().items()
          if not k.endswith("num_batches_tracked") and not k.startswith(heads)}
    back = convert_i3res50(sd)
    orig = {"params": {k: v for k, v in variables["params"]["i3d"].items() if k != "fc"},
            "batch_stats": variables["batch_stats"]["i3d"]}
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_orig = dict(jax.tree_util.tree_flatten_with_path(orig)[0])
    assert flat_back.keys() == flat_orig.keys()
    for k in flat_orig:
        np.testing.assert_array_equal(flat_back[k], flat_orig[k])


def test_bridge_is_strict():
    _, variables = jax_load_fa(image_size=(32, 32), dtype="float32", tiny=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    fa = load_fa_model(tiny=True, dtype="float32", device="cpu")

    extra = {**variables, "params": {**variables["params"], "bogus": {"kernel": np.zeros((1, 1))}}}
    with pytest.raises(KeyError, match="bogus"):
        load_jax_variables(fa, extra)

    head = dict(variables["params"]["head"])
    missing = {**variables, "params": {k: v for k, v in variables["params"].items() if k != "head"}}
    with pytest.raises(KeyError, match="head"):
        load_jax_variables(fa, missing)

    wrong = {**variables, "params": {**variables["params"],
                                     "head": {**head, "bias": np.zeros((4,), np.float32)}}}
    with pytest.raises(ValueError, match="head.bias"):
        load_jax_variables(fa, wrong)

    with pytest.raises(KeyError, match="collections"):
        load_jax_variables(fa, {**variables, "cache": {}})


def test_bridge_layout_rules():
    """Kernel transposes by rank, dense transpose, BN names."""
    tree = {
        "params": {
            "c1": {"kernel": np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)},
            "c2": {"kernel": np.zeros((3, 5, 2, 4), np.float32)},
            "c3": {"kernel": np.zeros((1, 3, 5, 2, 4), np.float32)},
            "fc": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3), "bias": np.zeros(3)},
            "bn": {"scale": np.ones(4), "bias": np.zeros(4)},
        },
        "batch_stats": {"bn": {"mean": np.zeros(4), "var": np.ones(4)}},
    }
    sd = flax_to_state_dict(tree)
    assert tuple(sd["c1.weight"].shape) == (4, 3, 2)
    assert float(sd["c1.weight"][3, 2, 1]) == tree["params"]["c1"]["kernel"][1, 2, 3]
    assert tuple(sd["c2.weight"].shape) == (4, 2, 3, 5)
    assert tuple(sd["c3.weight"].shape) == (4, 2, 1, 3, 5)
    assert tuple(sd["fc.weight"].shape) == (3, 2) and float(sd["fc.weight"][2, 1]) == 5.0
    assert {"bn.weight", "bn.bias", "bn.running_mean", "bn.running_var"} <= sd.keys()


def test_npz_variables_round_trip(tmp_path):
    tree = {"params": {"a": {"kernel": np.ones((2, 3), np.float32)}},
            "batch_stats": {"bn": {"mean": np.zeros(3, np.float32)}}}
    flat = {"params/a/kernel": tree["params"]["a"]["kernel"],
            "batch_stats/bn/mean": tree["batch_stats"]["bn"]["mean"]}
    np.savez(tmp_path / "v.npz", **flat)
    back = load_npz_variables(str(tmp_path / "v.npz"))
    np.testing.assert_array_equal(back["params"]["a"]["kernel"], tree["params"]["a"]["kernel"])
    np.testing.assert_array_equal(back["batch_stats"]["bn"]["mean"], np.zeros(3))
