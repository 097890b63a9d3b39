"""Port parity of the I3Res50 s2d stem (ted_spad_tpu_torch/ops/fast_i3d.py) against the
JAX package's ops/fast_i3d.py and against the port's module forward.

The full-width I3Res50 (``largei3d``) on 2 clips of 8x32x32, float32 on the CPU, weights
from the port's seeded init written out and perturbed leaf by leaf
(``test_torch_port_fullwidth.bridged``), then given to both packages, as
tests/test_fast_i3d.py holds the JAX form against its module. rtol / atol 2e-4, the JAX
package's own limits."""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_fullwidth import bridged
from ted_spad_tpu.models.i3res50 import WrapperI3D as JaxWrapperI3D
from ted_spad_tpu.ops import fast_i3d as jax_fast
from ted_spad_tpu_torch.models import load_ft_model
from ted_spad_tpu_torch.models.i3res50 import WrapperI3D
from ted_spad_tpu_torch.ops import fast_i3d
from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables

torch.set_num_threads(1)

RTOL = ATOL = 2e-4
CLASSES = 7


def assert_close(ours, ref) -> None:
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ref).all()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def i3res50():
    """(JAX module, its variables, the port's WrapperI3D with the same weights)."""
    ft = load_ft_model(num_classes=CLASSES, dtype="float32", device="cpu", clip_shape=(8, 32, 32))
    jmodel = JaxWrapperI3D(num_classes=CLASSES, dtype=jnp.float32)
    variables = bridged(ft, jmodel, jnp.zeros((1, 8, 32, 32, 3)), seed=11)
    return jmodel, variables, load_jax_variables(ft, variables)


def clips(seed: int, shape=(2, 8, 32, 32, 3)) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def ncdhw(x: np.ndarray) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, C, T, H, W) in channels_last_3d memory (a view)."""
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 6, 8, 5)).astype(np.float32)
    ours = fast_i3d.space_to_depth_2x2(torch.from_numpy(x))
    ref = np.asarray(jax_fast.space_to_depth_2x2(jnp.asarray(x)))
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(fast_i3d.depth_to_space_2x2(ours).numpy(),
                                  np.asarray(jax_fast.depth_to_space_2x2(jnp.asarray(ref))))
    np.testing.assert_array_equal(fast_i3d.depth_to_space_2x2(ours).numpy(), x)
    # The clip layout: (B, C, T, H, W) in and out, channels_last_3d memory.
    c = ncdhw(x)
    s = fast_i3d.space_to_depth_2x2(c, channel_dim=1)
    assert s.shape == (2, 20, 3, 3, 4)
    assert s.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_array_equal(s.permute(0, 2, 3, 4, 1).numpy(), ref)
    np.testing.assert_array_equal(fast_i3d.depth_to_space_2x2(s, channel_dim=1).numpy(),
                                  c.numpy())


def test_stem_s2d_kernel_matches_jax_and_the_stem_conv():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((5, 7, 7, 3, 8)).astype(np.float32)
    ours = fast_i3d.stem_s2d_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_fast.stem_s2d_kernel(jnp.asarray(w))))
    x = torch.from_numpy(rng.standard_normal((2, 3, 6, 16, 20)).astype(np.float32))
    wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2)
    ref = torch.nn.functional.conv3d(x, wt, stride=2, padding=(2, 3, 3))
    xs = torch.nn.functional.pad(fast_i3d.space_to_depth_2x2(x, channel_dim=1),
                                 (2, 1, 2, 1, 2, 2))
    got = torch.nn.functional.conv3d(xs, ours.permute(4, 3, 0, 1, 2), stride=(2, 1, 1))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 8, 32, 32, 3), (1, 6, 24, 40, 3)], ids=["square", "wide"])
def test_s2d_stem_matches_the_module_stem(i3res50, shape):
    """The stem (BN folded, ReLU) on s2d clips, with the channels zero-padded to 16,
    equals the module's stem ConvBN."""
    _, _, ft = i3res50
    x = ncdhw(clips(2, shape))
    with torch.inference_mode():
        ref = ft.i3d.stem(x)
        got = fast_i3d.s2d_stem(ft.i3d.stem, fast_i3d.space_to_depth_2x2(x, channel_dim=1),
                                torch.float32)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert_close(got.numpy(), ref.numpy())


@pytest.mark.parametrize("input_s2d", [False, True], ids=["rgb", "s2d"])
def test_fast_extract_matches_jax_and_module(i3res50, input_s2d):
    jmodel, variables, ft = i3res50
    x = clips(3)
    ref = np.asarray(jax.jit(functools.partial(jax_fast.make_fast_ft_extract(jmodel), train=False))(
        variables, x))
    extract = fast_i3d.make_fast_ft_extract(ft)
    assert extract.supports_s2d
    arg = fast_i3d.space_to_depth_2x2(ncdhw(x), channel_dim=1) if input_s2d else ncdhw(x)
    with torch.inference_mode():
        ours = extract(arg, input_s2d=input_s2d).numpy()
        module = ft.extract_features(ncdhw(x)).numpy()
    assert ours.shape == (2, 2048)
    assert_close(ours, ref)
    assert_close(ours, module)


@pytest.mark.parametrize("input_s2d", [False, True], ids=["rgb", "s2d"])
def test_fast_forward_matches_jax_and_module(i3res50, input_s2d):
    jmodel, variables, ft = i3res50
    x = clips(4)
    ref_logits, ref_emb = jax.jit(functools.partial(jax_fast.make_fast_ft_forward(jmodel),
                                                    train=False))(variables, x)
    forward = fast_i3d.make_fast_ft_forward(ft)
    arg = fast_i3d.space_to_depth_2x2(ncdhw(x), channel_dim=1) if input_s2d else ncdhw(x)
    with torch.inference_mode():
        logits, emb = forward(arg, input_s2d=input_s2d)
        mod_logits, mod_emb = ft(ncdhw(x))
    assert logits.shape == (2, CLASSES) and emb.shape == (2, 128)
    assert_close(logits.numpy(), ref_logits)
    assert_close(emb.numpy(), ref_emb)
    assert_close(logits.numpy(), mod_logits.numpy())
    assert_close(emb.numpy(), mod_emb.numpy())


def test_fallbacks_run_the_module(i3res50):
    """Odd frame sides and train mode run the module (an s2d input undone first); any
    model but WrapperI3D gets the module's own call, without supports_s2d. Train mode's
    own form, make_fast_ft_train_forward, routes as the JAX package's: the s2d stem
    conv at even sides (each FrozenBN value; output within 2e-4 of the module's train forward in
    float64, the statistics moved alike), the module at odd sides and for any other model."""
    _, _, ft = i3res50
    stems = []
    real = fast_i3d.s2d_stem

    def spy(*a, **k):
        stems.append(1)
        return real(*a, **k)

    odd = ncdhw(clips(5, (2, 8, 31, 32, 3)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fast_i3d, "s2d_stem", spy)
        with torch.inference_mode():
            got = fast_i3d.make_fast_ft_extract(ft)(odd)
            np.testing.assert_array_equal(got.numpy(), ft.extract_features(odd).numpy())
        assert stems == []
        x = ncdhw(clips(6))
        mod, ours = copy.deepcopy(ft), copy.deepcopy(ft)
        with torch.no_grad():
            ref = mod(x, train=True, frozen_bn=True, generator=torch.Generator().manual_seed(3))
            got = fast_i3d.make_fast_ft_forward(ours)(
                fast_i3d.space_to_depth_2x2(x, channel_dim=1), train=True, input_s2d=True,
                frozen_bn=True, generator=torch.Generator().manual_seed(3))
        assert stems == []
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        with torch.no_grad():
            ref = mod.extract_features(x, train=True)
            got = fast_i3d.make_fast_ft_extract(ours)(x, train=True)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        for (k, a), b in zip(mod.state_dict().items(), ours.state_dict().values()):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
        assert stems == []

        convs = []
        real_conv = fast_i3d.s2d_stem_conv
        mp.setattr(fast_i3d, "s2d_stem_conv", lambda *a: convs.append(1) or real_conv(*a))
        for frozen in (True, False):
            for clip, fast in ((x.double(), True), (odd.double(), False)):
                # float64: the MLP head's train-mode BN over two embeddings flips the
                # sign of an output wherever they differ by rounding
                mod, ours = copy.deepcopy(ft).double(), copy.deepcopy(ft).double()
                with torch.no_grad():
                    ref = mod(clip, train=True, frozen_bn=frozen,
                              generator=torch.Generator().manual_seed(4))
                    got = fast_i3d.make_fast_ft_train_forward(ours)(
                        clip, frozen_bn=frozen, generator=torch.Generator().manual_seed(4))
                assert (stems, convs) == (([], [1]) if fast else ([], []))
                stems.clear()
                convs.clear()
                check = assert_close if fast else np.testing.assert_array_equal
                for a, b in zip(got, ref):
                    check(a.numpy(), b.numpy())
                for a, b in zip(mod.state_dict().values(), ours.state_dict().values()):
                    check(b.numpy(), a.numpy())

    r3d = load_ft_model("r3d_18", dtype="float32", device="cpu")
    assert not isinstance(r3d, WrapperI3D)
    extract = fast_i3d.make_fast_ft_extract(r3d)
    forward = fast_i3d.make_fast_ft_forward(r3d)
    assert not hasattr(extract, "supports_s2d") and not hasattr(forward, "supports_s2d")
    x = ncdhw(clips(7, (2, 8, 32, 32, 3)))
    with torch.inference_mode():
        np.testing.assert_array_equal(extract(x).numpy(), r3d.extract_features(x).numpy())
        for a, b in zip(forward(x), r3d(x)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    mod = copy.deepcopy(r3d)
    with torch.no_grad():
        got = fast_i3d.make_fast_ft_train_forward(r3d)(x, generator=torch.Generator().manual_seed(5))
        ref = mod(x, train=True, generator=torch.Generator().manual_seed(5))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_gradient_reaches_the_clips_and_weights_follow(i3res50):
    """The frozen ft of the adversarial fa step: the fast forward's gradient to its input
    equals the module's (float64), with remat_blocks too; a stem weight changed after
    the forward was built shows in its next output."""
    _, _, base = i3res50
    ft = copy.deepcopy(base).double().requires_grad_(False)
    forward = fast_i3d.make_fast_ft_forward(ft)
    v = torch.from_numpy(np.random.default_rng(8).standard_normal(128))
    for remat in (False, True):
        grads = []
        for fn in (forward, ft):
            x = ncdhw(clips(9)).double().requires_grad_(True)
            logits, emb = fn(x, remat_blocks=remat)
            ((logits ** 2).mean() + (emb * v).mean()).backward()
            grads.append(x.grad.numpy())
        np.testing.assert_allclose(grads[0], grads[1], rtol=1e-9,
                                   atol=1e-9 * float(np.abs(grads[1]).max()))
    x = ncdhw(clips(10)).double()
    with torch.no_grad():
        before = forward(x)[0]
        ft.i3d.stem.bn.running_mean.add_(0.5)
        ft.i3d.stem.conv.weight.mul_(1.1)
        after, ref = forward(x)[0], ft(x)[0]
    assert float((after - before).abs().max()) > 1e-3
    np.testing.assert_allclose(after.numpy(), ref.numpy(), rtol=1e-10, atol=1e-10)
