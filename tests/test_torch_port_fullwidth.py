"""Port parity of the full-width fa and ft forwards: UNet++ (ResNet-18 encoder,
decoder (256, 128, 64, 32)) at 32x32 and I3Res50 ``extract_features`` on 8x32x32
clips, against the JAX modules in float32 on the CPU.

Weights: the port's seeded init written out by ``state_dict_to_flax`` (checked here
against the JAX module's own variables tree, key by key and shape by shape, from an
abstract init), perturbed leaf by leaf from a numpy seed so that every weight and BN
statistic differs from its default, then given to both sides (the port through
``load_jax_variables``). Tolerance 1e-4 relative to the output's largest magnitude:
float32 rounding through ~25 (UNet++) and ~53 (I3Res50) convolutions."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ted_spad_tpu.models.i3res50 import WrapperI3D as JaxWrapperI3D
from ted_spad_tpu.models.unet import UNetPlusPlus as JaxUNetPlusPlus
from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables, state_dict_to_flax

torch.set_num_threads(1)

TOL = 1e-4


def bridged(module, jax_module, example, seed: int):
    """The port's weights as a perturbed flax tree, after checking that its keys and
    shapes are the JAX module's (abstract init: no compile)."""
    shapes = jax.eval_shape(functools.partial(jax_module.init, train=False),
                            jax.random.PRNGKey(0), example)
    tree = state_dict_to_flax(module)
    want = {jax.tree_util.keystr(k): v.shape
            for k, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {jax.tree_util.keystr(k): v.shape
           for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x * rng.uniform(0.8, 1.2, x.shape) + 0.02 * rng.standard_normal(x.shape)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def assert_close(ours: np.ndarray, ref: np.ndarray) -> None:
    assert ours.shape == ref.shape and np.isfinite(ref).all()
    err = float(np.abs(ours - ref).max())
    assert err <= TOL * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


def test_full_width_unetpp_matches_jax():
    fa = load_fa_model(dtype="float32", device="cpu")
    jmodel = JaxUNetPlusPlus(dtype=jnp.float32)
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    variables = bridged(fa, jmodel, jnp.asarray(x), seed=0)
    ref = np.asarray(jax.jit(functools.partial(jmodel.apply, train=False))(variables, x))
    load_jax_variables(fa, variables)
    with torch.inference_mode():
        ours = fa(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert ours.shape == (2, 32, 32, 3)
    assert_close(ours, ref)


def test_full_width_i3res50_matches_jax_extract_features():
    ft = load_ft_model(dtype="float32", device="cpu")
    jmodel = JaxWrapperI3D(num_classes=400, dtype=jnp.float32)
    x = np.random.default_rng(3).uniform(0, 1, (2, 8, 32, 32, 3)).astype(np.float32)
    variables = bridged(ft, jmodel, jnp.asarray(x), seed=2)
    ref = np.asarray(jax.jit(functools.partial(jmodel.apply, train=False,
                                               method="extract_features"))(variables, x))
    load_jax_variables(ft, variables)
    with torch.inference_mode():
        ours = ft.extract_features(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).numpy()
    assert ours.shape == (2, 2048)
    assert_close(ours, ref)
