"""Port parity of the extraction options beside the default serving configuration:
``ncrops`` 5 and 10, ``no_ar_distortion`` and ``quirk_compat`` through the port's
``make_extract_step`` against the JAX package's (its XLA path, ``use_pallas=False``)
on the tiny UNet++ / I3Res50, one ``arch_ft="i3d"`` extraction end to end against the
JAX stage, the JAX stage's validation errors, and the XD-Violence serving CLI.

Float32 on the CPU, weights bridged from perturbed JAX variables
(``test_torch_port_slice._perturbed``). Tolerance 1e-4 of the features' largest
magnitude: the preprocess formulations differ by float32 rounding (1e-6 on the
image), which the float32 networks carry through."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ted_spad_tpu.stages.feature_extraction as jax_fe
from test_torch_port_fullwidth import bridged
from test_torch_port_slice import _perturbed
from ted_spad_tpu.config.params import FeatureExtractionParams as JaxFeatureExtractionParams
from ted_spad_tpu.models import load_fa_model as jax_load_fa
from ted_spad_tpu.models import load_ft_model as jax_load_ft
from ted_spad_tpu.models.i3d import InceptionI3d as JaxInceptionI3d
from ted_spad_tpu.ops import temporal as jax_temporal
from ted_spad_tpu_torch import score_video
from ted_spad_tpu_torch.config.params import FeatureExtractionParams
from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
from ted_spad_tpu_torch.ops import temporal
from ted_spad_tpu_torch.stages import feature_extraction as fe
from ted_spad_tpu_torch.utils.jax_weights import FT_HEADS, load_jax_variables

torch.set_num_threads(1)

TOL = 1e-4
COMMON = dict(num_frames=8, fix_skip=2, batch_size=2, reso_h=32, reso_w=32, compute_dtype="float32")


@pytest.fixture(scope="module")
def tiny_models():
    """(JAX fa pair, JAX ft pair, port fa, port ft) from the same perturbed variables."""
    fa_model, fa_vars = jax_load_fa(image_size=(32, 32), dtype="float32", tiny=True)
    ft_model, ft_vars = jax_load_ft(clip_shape=(8, 32, 32), dtype="float32", tiny=True)
    fa_vars, ft_vars = _perturbed(fa_vars, 0), _perturbed(ft_vars, 1)
    fa = load_jax_variables(load_fa_model(tiny=True, dtype="float32", device="cpu"), fa_vars)
    ft = load_jax_variables(load_ft_model(tiny=True, dtype="float32", device="cpu"), ft_vars,
                            skip=FT_HEADS)
    return (fa_model, fa_vars), (ft_model, ft_vars), fa, ft


def _assert_close(ours: np.ndarray, ref: np.ndarray) -> None:
    assert ours.shape == ref.shape and np.isfinite(ref).all()
    err = float(np.abs(ours - ref).max())
    assert err <= TOL * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


@pytest.mark.parametrize("option", [dict(ncrops=5), dict(ncrops=10), dict(no_ar_distortion=True),
                                    dict(quirk_compat=True)],
                         ids=["ncrops5", "ncrops10", "no_ar_distortion", "quirk_compat"])
def test_extract_step_options_match_jax(tiny_models, option):
    (jfa, jfa_vars), (jft, jft_vars), fa, ft = tiny_models
    clips = np.random.default_rng(sum(map(int, option.values()))).integers(
        0, 256, (2, 8, 40, 80, 3), dtype=np.uint8)
    jax_step = jax_fe.make_extract_step(jft, JaxFeatureExtractionParams(**COMMON, **option),
                                        fa=(jfa, jfa_vars), use_pallas=False)
    ref = np.asarray(jax_step(jft_vars, jnp.asarray(clips)))
    step = fe.make_extract_step(ft, FeatureExtractionParams(**COMMON, **option), fa, device="cpu")
    ours = step(torch.from_numpy(clips)).numpy()
    ncrops = option.get("ncrops", 1)
    assert ours.shape == ((2, ncrops, 256) if ncrops > 1 else (2, 256))
    _assert_close(ours, ref)


@pytest.mark.parametrize("t", [16, 8, 3])
def test_frame_layout_quirks_match_jax(t):
    """The reference's fa-input view (and its inverse) and the extraction's return
    scramble, on torch tensors, equal to the JAX package's (T % 3 != 0 included, where
    the 3-slice bundles straddle channels)."""
    video = np.random.default_rng(t).standard_normal((2, t, 5, 4, 3)).astype(np.float32)
    ours = temporal.scrambled_frame_view(torch.from_numpy(video))
    np.testing.assert_array_equal(ours.numpy(), jax_temporal.scrambled_frame_view(video))
    back = temporal.unscrambled_frame_view(ours, 2, t)
    np.testing.assert_array_equal(back.numpy(), jax_temporal.unscrambled_frame_view(ours.numpy(), 2, t))
    np.testing.assert_array_equal(back.numpy(), video)
    frames = video.reshape(2 * t, 5, 4, 3)
    np.testing.assert_array_equal(
        temporal.extraction_return_scramble(torch.from_numpy(frames), 2, t).numpy(),
        np.asarray(jax_temporal.extraction_return_scramble_jnp(jnp.asarray(frames), 2, t)))


def test_quirk_compat_changes_the_features(tiny_models):
    """The scramble is really applied: without it the features differ."""
    _, _, fa, ft = tiny_models
    clips = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 8, 40, 80, 3), np.uint8))
    plain = fe.make_extract_step(ft, FeatureExtractionParams(**COMMON), fa, device="cpu")(clips)
    quirk = fe.make_extract_step(ft, FeatureExtractionParams(**COMMON, quirk_compat=True), fa,
                                 device="cpu")(clips)
    assert float((plain - quirk).abs().max()) > 1e-3 * float(plain.abs().max())


def test_ten_crop_files_hold_every_crop(tmp_path, tiny_models):
    """extract_features writes (num_clips, ncrops, F) files whose rows are the step's."""
    _, _, fa, ft = tiny_models
    p = FeatureExtractionParams(**COMMON, ncrops=10)
    uris = ["synthetic://n=40,h=40,w=80,seed=3"]
    res = fe.extract_features(p, uris, str(tmp_path), fa=fa, ft=ft, decode_hw=(40, 80),
                              num_workers=1, device="cpu", log_fn=lambda s: None)
    feats = np.load(res["saved"][uris[0]])
    assert feats.shape == (2, 10, 256) and np.isfinite(feats).all()
    clips, _, _ = next(fe.iter_clip_batches(uris, p, 2, decode_hw=(40, 80), num_workers=1))
    step = fe.make_extract_step(ft, p, fa, device="cpu")
    np.testing.assert_array_equal(feats, step(torch.from_numpy(clips)).numpy())


def test_i3d_extraction_matches_jax_end_to_end(tmp_path, monkeypatch):
    """arch_ft="i3d" (full width, raw frames) at the smallest clip its pooled head
    admits, 9 frames of 193x193: the stage's 1024-d .npy files against the JAX stage's."""
    ft = load_ft_model("i3d", dtype="float32", device="cpu")
    jmodel = JaxInceptionI3d(dtype=jnp.float32)
    variables = bridged(ft, jmodel, jnp.zeros((1, 9, 193, 193, 3)), seed=5)
    load_jax_variables(ft, variables)
    monkeypatch.setattr(jax_fe, "load_ft_model", lambda *a, **k: (jmodel, variables))
    common = dict(num_frames=9, fix_skip=1, batch_size=2, reso_h=193, reso_w=193,
                  compute_dtype="float32", anonymized=False, arch_ft="i3d")
    uris = ["synthetic://n=9,h=40,w=80,seed=1", "synthetic://n=12,h=40,w=80,seed=2"]
    ref = jax_fe.extract_features(JaxFeatureExtractionParams(**common), uris, str(tmp_path / "jax"),
                                  decode_hw=(40, 80), num_workers=1, log_fn=lambda s: None)
    ours = fe.extract_features(FeatureExtractionParams(**common), uris, str(tmp_path / "port"),
                               ft=ft, decode_hw=(40, 80), num_workers=1, device="cpu",
                               log_fn=lambda s: None)
    assert ours["clips"] == ref["clips"] == 2
    for uri in uris:
        got, want = np.load(ours["saved"][uri]), np.load(ref["saved"][uri])
        assert got.shape[1:] == (1024,)
        _assert_close(got, want)


@pytest.mark.parametrize("option,error,match,jax_step_refuses", [
    (dict(ncrops=3), ValueError, "ncrops must be 1, 5 or 10", True),
    (dict(ncrops=10, quirk_compat=True), ValueError, "quirk_compat", True),
    (dict(ncrops=5, no_ar_distortion=True), ValueError, "no_ar_distortion", True),
    # The int8 mode is ported (tests/test_torch_port_quant.py): what is left to refuse is
    # a quant mode neither package has, which the JAX stage refuses in extract_features.
    (dict(quant="int4"), ValueError, "quant must be 'none' or 'int8'", False),
], ids=["ncrops3", "ncrops10_quirk", "ncrops5_no_ar", "int8"])
def test_validation_errors_match_jax(option, error, match, jax_step_refuses):
    ft = load_ft_model(tiny=True, dtype="float32", device="cpu")
    with pytest.raises(error, match=match):
        fe.make_extract_step(ft, FeatureExtractionParams(**option), device="cpu")
    if jax_step_refuses:  # the JAX stage refuses the same combination, in the same words
        jft, _ = jax_load_ft(clip_shape=(8, 32, 32), dtype="float32", tiny=True)
        with pytest.raises(ValueError, match=match):
            jax_fe.make_extract_step(jft, JaxFeatureExtractionParams(**option), use_pallas=False)


def test_score_video_serves_xd_with_the_i3d_ft(tmp_path):
    """score_video --datasetname XD on the CPU: an i3d ft (its smallest pooled clip,
    raw frames) gives 1024-d features, which the XD preset's MGFN scores; the UCF
    preset refuses them (from the same cached features) with the JAX CLI's message."""
    params = tmp_path / "params_i3d.py"
    params.write_text('arch_ft = "i3d"\n')
    argv = ["--synthetic", "--raw", "--device", "cpu", "--num_workers", "2", "--params", str(params)]
    summaries = score_video.run(score_video.parser().parse_args(
        argv + ["--datasetname", "XD", "--out_dir", str(tmp_path)]))
    assert len(summaries) == 2 and all("error" not in s for s in summaries)
    [feat_dir] = list((tmp_path / "features").iterdir())
    for s in summaries:
        feats = np.load(feat_dir / os.path.basename(s["scores"]))
        assert feats.shape == (s["clips"], 1024) and np.isfinite(feats).all()
        frames = np.load(s["scores"])
        assert s["clips"] == 2 and s["frames"] == len(frames) == 40
        assert np.all((frames >= 0) & (frames <= 1))
    with pytest.raises(SystemExit, match="expects 2048-d"):
        score_video.run(score_video.parser().parse_args(
            argv + ["--datasetname", "UCF", "--out_dir", str(tmp_path)]))


def test_extract_features_cli_on_cpu(tmp_path):
    """python -m ted_spad_tpu_torch.extract_features --synthetic --ncrops 5, in two
    shards: every video's (clips, 5, 2048) file lands once."""
    from ted_spad_tpu_torch import extract_features as cli

    for shard in (0, 1):
        res = cli.run(cli.parser().parse_args(
            ["--synthetic", "--device", "cpu", "--raw", "--ncrops", "5", "--num_workers", "2",
             "--out_dir", str(tmp_path), "--shard_id", str(shard), "--num_shards", "2"]))
        assert len(res["saved"]) == 2 and not res["skipped"]
    files = sorted(tmp_path.glob("*.npy"))
    assert len(files) == 4
    for f in files:
        feats = np.load(f)
        assert feats.shape == (7, 5, 2048) and np.isfinite(feats).all()
