"""Port parity for the plain-UNet anonymizer path (``arch_fa="unet"``): the port's
full-width UNet against the JAX UNet through the weight bridge, its bilinear
upsample, the extraction slice and MGFN scores with ``arch_fa="unet"`` against the
JAX package, and the serving CLI's ``--params`` overlay.

Weights are the JAX init with every leaf moved off its value from a numpy seed
(kernels scaled, 1-D leaves also shifted, BN variances redrawn), mild enough that
the sigmoid output stays away from saturation, so a wrong weight shows. Everything
is float32 on the CPU; each tolerance is stated where it is used."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ted_spad_tpu.stages.feature_extraction as jax_fe
from ted_spad_tpu.config.params import FeatureExtractionParams as JaxFeatureExtractionParams
from ted_spad_tpu.config.params import MGFNParams as JaxMGFNParams
from ted_spad_tpu.config.params import apply_params_file as jax_apply_params_file
from ted_spad_tpu.data.features import padded_test_batch as jax_padded_test_batch
from ted_spad_tpu.models import load_fa_model as jax_load_fa
from ted_spad_tpu.models import load_ft_model as jax_load_ft
from ted_spad_tpu.models import load_mgfn_model as jax_load_mgfn
from ted_spad_tpu.models.layers import resize_bilinear as jax_resize_bilinear
from ted_spad_tpu.ops.temporal import test_features as jax_with_magnitude
from ted_spad_tpu.stages.anomaly_detection import make_score_fn as jax_make_score_fn
from ted_spad_tpu_torch import score_video
from ted_spad_tpu_torch.config.params import (
    FeatureExtractionParams, MGFNParams, apply_params_file,
)
from ted_spad_tpu_torch.data.features import padded_test_batch
from ted_spad_tpu_torch.models import UNet, load_fa_model, load_ft_model, load_mgfn_model
from ted_spad_tpu_torch.models.layers import resize_bilinear
from ted_spad_tpu_torch.ops.temporal import test_features as with_magnitude
from ted_spad_tpu_torch.stages import feature_extraction as fe
from ted_spad_tpu_torch.stages.anomaly_detection import make_score_fn
from ted_spad_tpu_torch.utils.jax_weights import FT_HEADS, load_jax_variables

torch.set_num_threads(1)


def perturbed(variables, seed: int):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        noise = 0.05 * rng.standard_normal(x.shape) if x.ndim == 1 else 0.0
        return (x * rng.uniform(0.8, 1.2, x.shape) + noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module")
def jax_unet():
    model, variables = jax_load_fa(arch="unet", image_size=(32, 32), dtype="float32")
    return model, perturbed(variables, 0)


def _port_unet(variables) -> UNet:
    return load_jax_variables(load_fa_model("unet", dtype="float32", device="cpu"), variables)


def _run(fa: UNet, x_nhwc: np.ndarray) -> np.ndarray:
    with torch.inference_mode():
        return fa(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("hw", [(32, 32), (36, 44)])
def test_unet_full_width_matches_jax(jax_unet, hw):
    """Full-width UNet (64...512 channels), eval forward, at an even size and at an
    odd one whose decoder needs pad_to_match (36x44: 9x11 -> 4x5 -> up 8x10 -> pad).
    f32, 1e-4 absolute on the sigmoid output (float32 rounding over 19 convs, BN
    folded on the port's side)."""
    model, variables = jax_unet
    x = np.random.default_rng(1).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    ours = _run(_port_unet(variables), x)
    assert ours.shape == ref.shape == (2, *hw, 3)
    assert ref.std() > 0.05 and 0 < ref.min() and ref.max() < 1  # not saturated
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_unet_weights_loaded_later_are_used(jax_unet):
    """BN/bias folding happens on every call, so new weights change the output."""
    _, variables = jax_unet
    fa = _port_unet(variables)
    x = np.random.default_rng(2).uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    before = _run(fa, x)
    load_jax_variables(fa, perturbed(variables, 9))
    after = _run(fa, x)
    assert np.abs(after - before).max() > 1e-3
    load_jax_variables(fa, variables)
    np.testing.assert_array_equal(_run(fa, x), before)


def test_unet_factory_and_parameter_count(jax_unet):
    _, variables = jax_unet
    fa = load_fa_model("unet", dtype="float32", device="cpu")
    n_jax = sum(np.size(v) for v in jax.tree_util.tree_leaves(variables["params"]))
    assert isinstance(fa, UNet) and sum(p.numel() for p in fa.parameters()) == n_jax
    with pytest.raises(ValueError, match="tiny"):
        load_fa_model("unet", tiny=True, device="cpu")
    with pytest.raises(ValueError, match="invalid"):
        load_fa_model("unet3", device="cpu")


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 1, 4), (1, 4, 3, 2)])
def test_resize_bilinear_matches_jax(shape):
    """2x align_corners=True upsample; f32, 1e-6 (interpolation weights computed in
    float32 by both). bf16 input comes back bf16 and channels_last."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x), 2))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ours = resize_bilinear(xt, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    half = resize_bilinear(xt.bfloat16().contiguous(memory_format=torch.channels_last), 2)
    assert half.dtype == torch.bfloat16 and half.is_contiguous(memory_format=torch.channels_last)


def test_extract_features_unet_and_scores_match_jax(tmp_path, monkeypatch, jax_unet):
    """The slice with ``arch_fa="unet"``: one synthetic video through the JAX package's
    extract_features and the port's, the same bridged UNet (the full-width fa) and
    tiny ft on both sides; features within 1e-4 relative + 1e-5 absolute (float32
    rounding through fa and ft), MGFN scores within 1e-4."""
    fa_model, fa_vars = jax_unet
    ft_model, ft_vars = jax_load_ft(clip_shape=(8, 32, 32), dtype="float32", tiny=True)
    ft_vars = perturbed(ft_vars, 1)
    asked = []

    def jax_fa(_saved, arch, **_):
        asked.append(("jax", arch))
        return fa_model, fa_vars

    monkeypatch.setattr(jax_fe, "load_fa_model", jax_fa)
    monkeypatch.setattr(jax_fe, "load_ft_model", lambda *a, **k: (ft_model, ft_vars))
    uris = ["synthetic://n=40,h=40,w=80,seed=5"]
    common = dict(num_frames=8, fix_skip=2, batch_size=2, reso_h=32, reso_w=32,
                  compute_dtype="float32", arch_fa="unet")
    ref = jax_fe.extract_features(JaxFeatureExtractionParams(**common), uris,
                                  str(tmp_path / "jax"), decode_hw=(40, 80), num_workers=1,
                                  log_fn=lambda s: None)

    def port_fa(arch, **kw):
        asked.append(("port", arch))
        assert kw["device"] == torch.device("cpu")
        return _port_unet(fa_vars)

    monkeypatch.setattr(fe, "load_fa_model", port_fa)
    ft = load_jax_variables(load_ft_model(tiny=True, dtype="float32", device="cpu"), ft_vars,
                            skip=FT_HEADS)
    ours = fe.extract_features(FeatureExtractionParams(**common), uris, str(tmp_path / "port"),
                               ft=ft, decode_hw=(40, 80), num_workers=1, device="cpu",
                               log_fn=lambda s: None)
    assert asked == [("jax", "unet"), ("port", "unet")]
    assert ours["clips"] == ref["clips"] == 2

    mp = dict(dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16, feature_size=256)
    jmodel, mvars = jax_load_mgfn(JaxMGFNParams.for_dataset("UCF").replace(**mp), ncrops=1)
    mvars = perturbed(mvars, 2)
    model = load_jax_variables(
        load_mgfn_model(MGFNParams.for_dataset("UCF").replace(**mp), device="cpu"), mvars)
    got, want = np.load(ours["saved"][uris[0]]), np.load(ref["saved"][uris[0]])
    assert got.shape == want.shape == (2, 256)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    video, mask, t = padded_test_batch(with_magnitude(got))
    jvideo, jmask, _ = jax_padded_test_batch(jax_with_magnitude(want))
    s_ours = make_score_fn(model, device="cpu")(video, mask)[0, :t].numpy()
    s_ref = np.asarray(jax_make_score_fn(jmodel)(mvars, jvideo, jmask))[0, :t]
    np.testing.assert_allclose(s_ours, s_ref, atol=1e-4, rtol=0)


def test_extract_step_use_kernel_selects_k2_for_the_unet(monkeypatch):
    """The step's one switch reaches the UNet: use_kernel=True sends each of its nine
    DoubleConvs through the kernel wrapper, False through the plain version only. On
    the CPU both compute the plain version, so the features agree exactly."""
    import ted_spad_tpu_torch.models.unet as unet_module

    calls = []
    wrapper = unet_module.fused_double_conv
    monkeypatch.setattr(unet_module, "fused_double_conv",
                        lambda *a: calls.append(a[0].shape) or wrapper(*a))
    p = FeatureExtractionParams(num_frames=8, reso_h=32, reso_w=32, compute_dtype="float32",
                                arch_fa="unet")
    fa = load_fa_model("unet", dtype="float32", device="cpu")
    ft = load_ft_model(tiny=True, dtype="float32", device="cpu")
    clips = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (1, 8, 40, 48, 3), dtype=np.uint8))
    plain = fe.make_extract_step(ft, p, fa, use_kernel=False, device="cpu")(clips)
    assert calls == []
    kernel = fe.make_extract_step(ft, p, fa, use_kernel=True, device="cpu")(clips)
    assert len(calls) == 9 and calls[0] == (8, 32, 32, 3)
    torch.testing.assert_close(kernel, plain, rtol=0, atol=0)


def _params_file(tmp_path) -> str:
    path = tmp_path / "params_unet.py"
    path.write_text('arch_fa = "unet"\nbatch_size = 3\nnot_a_field = 1\n_private = 2\n')
    return str(path)


def test_apply_params_file_matches_jax(tmp_path):
    path = _params_file(tmp_path)
    ours = apply_params_file(FeatureExtractionParams(), path)
    ref = jax_apply_params_file(JaxFeatureExtractionParams(), path)
    assert (ours.arch_fa, ours.batch_size) == (ref.arch_fa, ref.batch_size) == ("unet", 3)
    for field in ("num_frames", "fix_skip", "cropping_factor", "arch_ft", "compute_dtype"):
        assert getattr(ours, field) == getattr(ref, field)
    assert apply_params_file(FeatureExtractionParams(), None) == FeatureExtractionParams()


def test_score_video_params_selects_unet_on_cpu(tmp_path, monkeypatch):
    """``--params`` with ``arch_fa = "unet"``: the serving CLI runs the UNet fa, scores
    every video in [0, 1], and keys its feature cache on the overlay."""
    calls = []
    real_forward = UNet.forward

    def counting_forward(self, x, use_kernel=True):
        calls.append(tuple(x.shape))
        return real_forward(self, x, use_kernel)

    monkeypatch.setattr(UNet, "forward", counting_forward)
    args = score_video.parser().parse_args(
        ["--synthetic", "--device", "cpu", "--out_dir", str(tmp_path), "--num_workers", "2",
         "--params", _params_file(tmp_path)])
    summaries = score_video.run(args)
    assert len(summaries) == 2 and all("error" not in s for s in summaries)
    assert calls and all(shape[1:] == (3, 32, 32) for shape in calls)
    for s in summaries:
        frames = np.load(s["scores"])
        assert s["clips"] == 7 and len(frames) == 120 and np.all((frames >= 0) & (frames <= 1))
    [feat_dir] = (tmp_path / "features").iterdir()
    cfg = (feat_dir / "_extract_config.txt").read_text()
    assert "arch_fa='unet'" in cfg and "params_unet.py" in cfg
    assert len(os.listdir(feat_dir)) == 3  # config + two .npy
