"""Port parity of the UNet++ eval fast path (ted_spad_tpu_torch/ops/fast_unetpp.py)
against the JAX package's ops/fast_unetpp.py and against the port's module forward.

The full-width UNet++ (decoder (256, 128, 64, 32)) at 2 frames of 32^2 (64^2 for the
s2d head), float32 on the CPU, weights from the port's seeded init written out and
perturbed leaf by leaf (``test_torch_port_fullwidth.bridged``), then given to both
packages. Every kernel transform is held against JAX's, every fast function against
JAX's fast function and the port's module forward at rtol / atol 2e-4 (the JAX
package's own limits), and every fallback of ``make_fast_fa_apply`` is reproduced."""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_fullwidth import bridged
from ted_spad_tpu.config.params import FeatureExtractionParams as JaxFeatureExtractionParams
from ted_spad_tpu.models.i3res50 import WrapperI3D as JaxWrapperI3D
from ted_spad_tpu.models.unet import UNetPlusPlus as JaxUNetPlusPlus
from ted_spad_tpu.ops import fast_i3d as jax_fast_i3d
from ted_spad_tpu.ops import fast_unetpp as jax_fast
from ted_spad_tpu.stages import feature_extraction as jax_fe
from ted_spad_tpu_torch.config.params import FeatureExtractionParams
from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
from ted_spad_tpu_torch.models.unet import UNetPlusPlus
from ted_spad_tpu_torch.ops import fast_i3d, fast_unetpp
from ted_spad_tpu_torch.stages import feature_extraction as fe
from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables

torch.set_num_threads(1)

RTOL = ATOL = 2e-4


def assert_close(ours, ref) -> None:
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ref).all()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def unetpp():
    """(JAX module, its variables, the port's UNet++ with the same weights)."""
    fa = load_fa_model(dtype="float32", device="cpu")
    jmodel = JaxUNetPlusPlus(dtype=jnp.float32)
    variables = bridged(fa, jmodel, jnp.zeros((1, 32, 32, 3)), seed=5)
    return jmodel, variables, load_jax_variables(fa, variables)


def frames(n: int, side: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (n, side, side, 3)).astype(np.float32)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def module_out(fa, x: np.ndarray) -> np.ndarray:
    with torch.inference_mode():
        return fa(nchw(x)).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", ["up2_fuse_kernel", "up2_dilated_kernel", "stem2d_s2d_kernel",
                                  "head_s2d_kernel"])
def test_kernel_transform_matches_jax(name):
    shape = (7, 7, 3, 8) if name == "stem2d_s2d_kernel" else (3, 3, 5, 6)
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ours = getattr(fast_unetpp, name)(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(ours, np.asarray(getattr(jax_fast, name)(jnp.asarray(w))),
                               rtol=0, atol=1e-6)


def test_kernel_transforms_are_the_convs_they_replace():
    """Port-side identities: up2_fuse + depth_to_space == conv3x3 of the nearest up2;
    the s2d stem == the 7x7 stride-2 stem; the s2d head == s2d of the 3x3 head."""
    rng = np.random.default_rng(1)
    conv = fast_unetpp.conv_nhwc
    x = torch.from_numpy(rng.standard_normal((2, 8, 10, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 5, 7)).astype(np.float32))
    up = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
    ref = conv(up, w, (1, 1), ((1, 1), (1, 1)), torch.float32)
    got = fast_unetpp.depth_to_space(conv(x, fast_unetpp.up2_fuse_kernel(w), (1, 1),
                                          ((1, 1), (1, 1)), torch.float32), 7)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(fast_unetpp.up2_conv(x, fast_unetpp.up2_dilated_kernel(w),
                                                    torch.float32).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(fast_unetpp.depth_to_space(
        fast_i3d.space_to_depth_2x2(up), 5).numpy(), up.numpy())
    with pytest.raises(AssertionError):
        fast_unetpp.depth_to_space(up, 7)

    img = torch.from_numpy(rng.standard_normal((2, 16, 20, 3)).astype(np.float32))
    w7 = torch.from_numpy(rng.standard_normal((7, 7, 3, 8)).astype(np.float32))
    ref = conv(img, w7, (2, 2), ((3, 3), (3, 3)), torch.float32)
    got = conv(fast_i3d.space_to_depth_2x2(img), fast_unetpp.stem2d_s2d_kernel(w7), (1, 1),
               ((2, 1), (2, 1)), torch.float32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-4)

    head = torch.nn.Conv2d(5, 3, 3, padding=1)
    xh = torch.from_numpy(rng.standard_normal((2, 8, 12, 5)).astype(np.float32))
    with torch.no_grad():
        plain = fast_unetpp._apply_head(head, xh, 8, 12, torch.float32)
        s2d = fast_unetpp._apply_head(head, xh, 8, 12, torch.float32, emit_s2d=True)
    np.testing.assert_allclose(s2d.numpy(), fast_i3d.space_to_depth_2x2(plain).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stem_mode", ["plain", "s2d"])
def test_fast_encoder_matches_jax_and_module(unetpp, stem_mode):
    jmodel, variables, fa = unetpp
    x = frames(2, 32, 1)
    ref = jax.jit(functools.partial(jax_fast.fast_encoder_apply, dtype=jnp.float32,
                                    stem_mode=stem_mode))(
        variables["params"]["encoder"], variables["batch_stats"]["encoder"], x)
    with torch.inference_mode():
        ours = fast_unetpp.fast_encoder_apply(fa.encoder, torch.from_numpy(x), torch.float32,
                                              stem_mode)
        module = fa.encoder(nchw(x))[1:]
    assert len(ours) == len(ref) == len(module) == 4
    for a, b, m in zip(ours, ref, module):
        assert_close(a.numpy(), b)
        assert_close(a.numpy(), m.permute(0, 2, 3, 1).numpy())
    with torch.no_grad():  # the unfolded stem conv of the int8 path's helper, in each mode
        stem = fast_unetpp._stem_conv(fa.encoder.stem, torch.from_numpy(x), torch.float32,
                                      mode=stem_mode)
        ref = fa.encoder.stem.conv(nchw(x)).permute(0, 2, 3, 1)
    assert_close(stem.numpy(), ref.numpy())


@pytest.mark.parametrize("encoder", ["inline", "inline_s2d_stem", "module"])
@pytest.mark.parametrize("emit_s2d", [False, True], ids=["rgb", "s2d"])
def test_fast_unetpp_apply_matches_jax_and_module(unetpp, emit_s2d, encoder):
    """The fused decoder over the inline encoder in each stem mode and over the module
    encoder, with each head."""
    jmodel, variables, fa = unetpp
    x = frames(2, 64 if emit_s2d else 32, 2)
    ref = np.asarray(jax.jit(functools.partial(
        jax_fast.fast_unetpp_apply, dtype=jnp.float32, emit_s2d=emit_s2d))(variables, x))

    def module_encoder(nhwc):
        return [t.permute(0, 2, 3, 1) for t in fa.encoder(nhwc.permute(0, 3, 1, 2))]

    with torch.inference_mode():
        ours = fast_unetpp.fast_unetpp_apply(
            fa, torch.from_numpy(x), emit_s2d=emit_s2d,
            stem_mode="s2d" if encoder == "inline_s2d_stem" else "plain",
            encoder_apply=module_encoder if encoder == "module" else None)
    assert ours.dtype == torch.float32
    assert_close(ours.numpy(), ref)
    module = module_out(fa, x)
    if emit_s2d:
        module = fast_i3d.space_to_depth_2x2(torch.from_numpy(module)).numpy()
        assert ours.shape == (2, 32, 32, 12)
    assert_close(ours.numpy(), module)


def test_make_fast_fa_apply_routes_like_jax(unetpp):
    """The 16-aligned eval call runs the fused form (NCHW in and out, emit_s2d as
    (N, 12, H/2, W/2)), against JAX's make_fast_fa_apply; sides 16 does not divide run
    the module, with emit_s2d followed by the s2d relayout (the JAX module refuses
    them: its skip padding cannot crop, the port's can)."""
    jmodel, variables, fa = unetpp
    jax_apply = jax_fast.make_fast_fa_apply(jmodel, variables)
    apply = fast_unetpp.make_fast_fa_apply(fa)
    assert apply.supports_s2d and jax_apply.supports_s2d
    calls = []
    real = fast_unetpp.fast_unetpp_apply

    def spy(*a, **k):
        calls.append(k.get("emit_s2d"))
        return real(*a, **k)

    for side, emit in ((32, False), (32, True), (40, False), (40, True)):
        x = frames(2, side, side + emit)
        if side % 16:
            ref = module_out(fa, x)
            if emit:
                ref = fast_i3d.space_to_depth_2x2(torch.from_numpy(ref)).numpy()
        else:
            ref = np.asarray(jax.jit(functools.partial(jax_apply, train=False, emit_s2d=emit))(
                variables, x))
        with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(fast_unetpp, "fast_unetpp_apply", spy)
            ours = apply(nchw(x), emit_s2d=emit).permute(0, 2, 3, 1).numpy()
        assert_close(ours, ref)
        assert calls == ([emit] if side % 16 == 0 else []), (side, calls)
        calls.clear()


def test_train_mode_runs_the_module(unetpp):
    """train=True routes as the JAX package's make_fast_fa_apply: at sides 16 divides
    the train form (``fast_unetpp_train_apply``: BN batch statistics, the running ones
    moved as the module moves them, output within 2e-4 of the module's); with emit_s2d,
    or at sides 16 does not divide, the module, exactly (emit_s2d followed by the s2d
    relayout)."""
    _, _, fa = unetpp
    calls = []
    real = fast_unetpp.fast_unetpp_train_apply

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    for side, emit in ((32, False), (32, True), (40, False)):
        x = nchw(frames(3, side, 3))
        mod, ours = copy.deepcopy(fa), copy.deepcopy(fa)
        with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(fast_unetpp, "fast_unetpp_train_apply", spy)
            ref = mod(x, train=True)
            got = fast_unetpp.make_fast_fa_apply(ours)(x, train=True, emit_s2d=emit)
        fast = side % 16 == 0 and not emit
        assert calls == ([1] if fast else []), (side, emit)
        calls.clear()
        if emit:
            ref = fast_i3d.space_to_depth_2x2(ref, 1)
        check = assert_close if fast else np.testing.assert_array_equal
        check(got.numpy(), ref.numpy())
        for (k, a), b in zip(mod.state_dict().items(), ours.state_dict().values()):
            check(b.numpy(), a.numpy())


def test_non_standard_models_fall_back_like_jax():
    """A tiny decoder runs the module (emit_s2d refused), against JAX's; a standard
    decoder over a non-standard encoder runs the module encoder inside the fused
    decoder, against the port's module (the JAX package's fallback builds a (2, 2, 2, 2)
    encoder, which cannot apply a (1, 1, 1, 1) tree); a UNet runs its module with its
    own keywords."""
    tiny = load_fa_model(tiny=True, dtype="float32", device="cpu")
    jtiny = JaxUNetPlusPlus(decoder_channels=(16, 8, 8, 8), encoder_layers=(1, 1, 1, 1),
                            encoder_width=8, dtype=jnp.float32)
    tvars = bridged(tiny, jtiny, jnp.zeros((1, 32, 32, 3)), seed=6)
    load_jax_variables(tiny, tvars)
    x = frames(2, 32, 4)
    apply = fast_unetpp.make_fast_fa_apply(tiny)
    assert not apply.supports_s2d
    with torch.inference_mode():
        ours = apply(nchw(x)).permute(0, 2, 3, 1).numpy()
        with pytest.raises(ValueError, match="emit_s2d"):
            apply(nchw(x), emit_s2d=True)
    np.testing.assert_array_equal(ours, module_out(tiny, x))
    ref = jax_fast.make_fast_fa_apply(jtiny, tvars)(tvars, x, train=False)
    assert_close(ours, ref)

    odd = UNetPlusPlus(encoder_layers=(1, 1, 1, 1), generator=torch.Generator().manual_seed(1))
    assert not fast_unetpp.encoder_layout_standard(odd.encoder)
    encoder_calls = []
    odd.encoder.register_forward_hook(lambda *a: encoder_calls.append(1))
    with torch.inference_mode():
        ours = fast_unetpp.make_fast_fa_apply(odd)(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert encoder_calls == [1]
    assert_close(ours, module_out(odd, x))
    wide = UNetPlusPlus(encoder_layers=(3, 2, 2, 2), generator=torch.Generator().manual_seed(2))
    assert not fast_unetpp.encoder_layout_standard(wide.encoder)

    seen = []

    class UNetLike(torch.nn.Module):
        def forward(self, x, use_kernel=True, train=False):
            seen.append((use_kernel, train))
            return x * 2

    plain = fast_unetpp.make_fast_fa_apply(UNetLike())
    assert not plain.supports_s2d
    assert torch.equal(plain(torch.ones(1, 3, 32, 32), use_kernel=False), torch.full((1, 3, 32, 32), 2.0))
    assert seen == [(False, False)]
    with pytest.raises(ValueError):
        plain(torch.ones(1, 3, 32, 32), emit_s2d=True)


def test_folded_weights_follow_the_module(unetpp):
    """The apply built once keeps no copy of the weights: an optimizer-style in-place
    update, a load_state_dict and a BN statistic written in place all show in its next
    output; an unchanged module reuses its folded weights."""
    _, _, base = unetpp
    fa = copy.deepcopy(base)
    apply = fast_unetpp.make_fast_fa_apply(fa)
    x = nchw(frames(2, 32, 5))
    folds = []
    real = fast_unetpp.fold_unetpp

    def counting(*a, **k):
        folds.append(1)
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fast_unetpp, "fold_unetpp", counting)
        for change in (None, None,
                       lambda: fa.x_0_2.conv2.conv.weight.add_(0.05),
                       lambda: fa.load_state_dict(base.state_dict()),
                       lambda: fa.encoder.layer2_0.conv1.bn.running_var.mul_(1.5),
                       lambda: fa.head.bias.add_(0.3)):
            if change is not None:
                with torch.no_grad():
                    change()
            with torch.inference_mode():
                ours, ref = apply(x), fa(x)
            assert_close(ours.numpy(), ref.numpy())
    assert len(folds) == 5  # one per distinct set of weights


def test_extract_step_bridged_matches_jax(unetpp, monkeypatch):
    """make_extract_step at 32^2 with the full-width fa and ft: the fa's s2d head feeds
    the ft's s2d stem (input_s2d), and the features equal the JAX package's step and
    the port's module step within 1e-4 of their largest magnitude (the extraction
    tests' limit: the two preprocess formulations differ by float32 rounding, which
    the two full-width networks carry to features of magnitude ~600)."""
    jmodel, fa_vars, fa = unetpp
    ft = load_ft_model(dtype="float32", device="cpu", clip_shape=(8, 32, 32))
    jft = JaxWrapperI3D(num_classes=400, dtype=jnp.float32)
    ft_vars = bridged(ft, jft, jnp.zeros((1, 8, 32, 32, 3)), seed=8)
    load_jax_variables(ft, ft_vars)
    common = dict(num_frames=8, fix_skip=2, batch_size=2, reso_h=32, reso_w=32,
                  compute_dtype="float32")
    clips = np.random.default_rng(9).integers(0, 256, (2, 8, 40, 48, 3), dtype=np.uint8)
    jax_step = jax_fe.make_extract_step(jft, JaxFeatureExtractionParams(**common),
                                        fa=(jmodel, fa_vars), use_pallas=False)
    ref = np.asarray(jax_step(ft_vars, jnp.asarray(clips)))

    seen = []
    real = fe.make_fast_ft_extract

    def recording(model):
        fn = real(model)

        def extract(x, **kw):
            seen.append((tuple(x.shape), kw))
            return fn(x, **kw)

        extract.supports_s2d = fn.supports_s2d
        return extract

    monkeypatch.setattr(fe, "make_fast_ft_extract", recording)
    step = fe.make_extract_step(ft, FeatureExtractionParams(**common), fa, device="cpu")
    ours = step(torch.from_numpy(clips)).numpy()
    assert seen == [((2, 12, 8, 16, 16), {"input_s2d": True})]
    assert ours.shape == (2, 2048)
    module = fe.make_extract_step(ft, FeatureExtractionParams(**common), fa, device="cpu",
                                  fast_forms=False)(torch.from_numpy(clips)).numpy()
    for other in (ref, module):
        assert np.isfinite(other).all()
        assert float(np.abs(ours - other).max()) <= 1e-4 * float(np.abs(other).max())
    assert jax_fast_i3d.make_fast_ft_extract(jft).supports_s2d
