"""Port parity for the serving slice as a whole: synthetic videos -> the port's
``extract_features`` -> .npy -> MGFN scores, against the JAX package's ``extract_features`` with
the same (bridged) weights, plus the slice's host-side helpers, the serving CLI,
and the package rules (no JAX import; CUDA unless device='cpu').

Everything runs on the CPU in float32 at tiny widths. Feature tolerance 1e-4
relative + 1e-5 absolute: the two preprocess formulations differ by float32
rounding (1e-5 on the image), which the f32 networks carry through."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import ted_spad_tpu.stages.feature_extraction as jax_fe
from ted_spad_tpu.config.params import FeatureExtractionParams as JaxFeatureExtractionParams
from ted_spad_tpu.config.params import MGFNParams as JaxMGFNParams
from ted_spad_tpu.data.features import padded_test_batch as jax_padded_test_batch
from ted_spad_tpu.models import load_fa_model as jax_load_fa
from ted_spad_tpu.models import load_ft_model as jax_load_ft
from ted_spad_tpu.models import load_mgfn_model as jax_load_mgfn
from ted_spad_tpu.ops.metrics import frame_level_scores as jax_frame_level_scores
from ted_spad_tpu.ops.temporal import test_features as jax_with_magnitude
from ted_spad_tpu.stages.anomaly_detection import make_score_fn as jax_make_score_fn
from ted_spad_tpu.utils.naming import dedup_names as jax_dedup_names
from ted_spad_tpu_torch import score_video, train_mgfn
from ted_spad_tpu_torch.config.params import FeatureExtractionParams, MGFNParams
from ted_spad_tpu_torch.data.features import padded_test_batch
from ted_spad_tpu_torch.models import load_fa_model, load_ft_model, load_mgfn_model
from ted_spad_tpu_torch.ops.metrics import frame_level_scores
from ted_spad_tpu_torch.ops.temporal import test_features as with_magnitude
from ted_spad_tpu_torch.stages import feature_extraction as fe
from ted_spad_tpu_torch.stages.anomaly_detection import (
    make_optimizer, make_score_fn, make_train_step, train_anomaly_detection,
)
from ted_spad_tpu_torch.utils.jax_weights import FT_HEADS, load_jax_variables
from ted_spad_tpu_torch.utils.naming import dedup_names

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
URIS = [f"synthetic://n={n},h=40,w=80,seed={s}" for n, s in ((60, 0), (40, 1001), (10, 2))]
FEAT_RTOL, FEAT_ATOL = 1e-4, 1e-5


def _perturbed(variables, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32) * rng.uniform(0.8, 1.2, np.shape(x))
                   + 0.05 * rng.standard_normal(np.shape(x))).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, variables))


def test_extract_features_and_scores_match_jax(tmp_path, monkeypatch):
    fa_model, fa_vars = jax_load_fa(image_size=(32, 32), dtype="float32", tiny=True)
    ft_model, ft_vars = jax_load_ft(clip_shape=(8, 32, 32), dtype="float32", tiny=True)
    fa_vars, ft_vars = _perturbed(fa_vars, 0), _perturbed(ft_vars, 1)
    # The JAX extract_features builds full-width models; hand it the tiny ones.
    monkeypatch.setattr(jax_fe, "load_fa_model", lambda *a, **k: (fa_model, fa_vars))
    monkeypatch.setattr(jax_fe, "load_ft_model", lambda *a, **k: (ft_model, ft_vars))
    common = dict(num_frames=8, fix_skip=2, batch_size=4, reso_h=32, reso_w=32,
                  compute_dtype="float32")
    ref = jax_fe.extract_features(JaxFeatureExtractionParams(**common), URIS,
                                  str(tmp_path / "jax"), decode_hw=(40, 80), num_workers=2,
                                  log_fn=lambda s: None)

    fa = load_jax_variables(load_fa_model(tiny=True, dtype="float32", device="cpu"), fa_vars)
    ft = load_jax_variables(load_ft_model(tiny=True, dtype="float32", device="cpu"), ft_vars,
                            skip=FT_HEADS)
    ours = fe.extract_features(FeatureExtractionParams(**common), URIS, str(tmp_path / "port"),
                               fa=fa, ft=ft, decode_hw=(40, 80), num_workers=2, device="cpu",
                               log_fn=lambda s: None)
    assert ours["clips"] == ref["clips"] == 3 + 2 + 1
    assert sorted(map(os.path.basename, ours["saved"].values())) == sorted(
        map(os.path.basename, ref["saved"].values()))

    mp = dict(dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16, feature_size=256)
    jmodel, mvars = jax_load_mgfn(JaxMGFNParams.for_dataset("UCF").replace(**mp), ncrops=1)
    mvars = _perturbed(mvars, 2)
    jscore = jax_make_score_fn(jmodel)
    model = load_jax_variables(
        load_mgfn_model(MGFNParams.for_dataset("UCF").replace(**mp), device="cpu"), mvars)
    score_fn = make_score_fn(model, device="cpu")
    for uri, path in ours["saved"].items():
        got, want = np.load(path), np.load(ref["saved"][uri])
        assert got.shape == want.shape and got.shape[1] == 256
        np.testing.assert_allclose(got, want, rtol=FEAT_RTOL, atol=FEAT_ATOL)
        # Scores: port on port features vs JAX on JAX features (sigmoid, f32).
        video, mask, t = padded_test_batch(with_magnitude(got))
        jvideo, jmask, _ = jax_padded_test_batch(jax_with_magnitude(want))
        s_ours = score_fn(video, mask)[0, :t].numpy()
        s_ref = np.asarray(jscore(mvars, jvideo, jmask))[0, :t]
        np.testing.assert_allclose(s_ours, s_ref, atol=1e-4, rtol=0)

    # Resume: a second run skips every video and reports it as existing.
    again = fe.extract_features(FeatureExtractionParams(**common), URIS, str(tmp_path / "port"),
                                fa=fa, ft=ft, decode_hw=(40, 80), device="cpu",
                                log_fn=lambda s: None)
    assert again["clips"] == 0 and again["existing"] == ours["saved"]


def test_extract_features_skips_undecodable_and_shards(tmp_path, monkeypatch):
    bad = "synthetic://n=40,h=40,w=80,seed=9"
    real_open = fe.open_video

    def open_video(uri, *a, **k):
        if uri == bad:
            raise IOError("corrupt stream")
        return real_open(uri, *a, **k)

    monkeypatch.setattr(fe, "open_video", open_video)
    p = FeatureExtractionParams(num_frames=8, reso_h=32, reso_w=32, compute_dtype="float32",
                                anonymized=False)
    ft = load_ft_model(tiny=True, dtype="float32", device="cpu")
    uris = [URIS[0], bad, URIS[1], URIS[2]]
    shard0 = fe.extract_features(p, uris, str(tmp_path), ft=ft, batch_size=2, decode_hw=(40, 80),
                                 num_workers=2, shard_id=0, num_shards=2, device="cpu",
                                 log_fn=lambda s: None)
    assert set(shard0["saved"]) == {URIS[0], URIS[1]} and not shard0["skipped"]
    shard1 = fe.extract_features(p, uris, str(tmp_path), ft=ft, batch_size=2, decode_hw=(40, 80),
                                 num_workers=2, shard_id=1, num_shards=2, device="cpu",
                                 log_fn=lambda s: None)
    assert set(shard1["saved"]) == {URIS[2]} and set(shard1["skipped"]) == {bad}
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_clip_batches_match_jax():
    """Packing across videos, short-video and last-batch padding, refs and counts.
    Videos are packed in decode-completion order, which timing decides, so the
    comparison is per (video, clip)."""
    p_jax = JaxFeatureExtractionParams(num_frames=8, fix_skip=2)
    p = FeatureExtractionParams(num_frames=8, fix_skip=2)

    def by_clip(batches):
        clips = {}
        for c, refs, _ in batches:
            for row, ref in enumerate(refs):
                clips[(ref.video_idx, ref.clip_idx)] = c[row]
            for row in range(len(refs), len(c)):  # padding repeats the last real clip
                np.testing.assert_array_equal(c[row], c[len(refs) - 1])
        return clips, batches[-1][2]

    ref = list(jax_fe.iter_clip_batches(URIS, p_jax, 4, decode_hw=(40, 80), num_workers=1))
    ours = list(fe.iter_clip_batches(URIS, p, 4, decode_hw=(40, 80), num_workers=1))
    assert len(ours) == len(ref) == 2 and [len(b[0]) for b in ours] == [4, 4]
    (clips, counts), (clips_j, counts_j) = by_clip(ours), by_clip(ref)
    assert counts == counts_j == {0: 3, 1: 2, 2: 1}
    assert clips.keys() == clips_j.keys()
    for key in clips:
        np.testing.assert_array_equal(clips[key], clips_j[key])


@pytest.mark.parametrize("total,frames,stride,step", [
    (60, 8, 2, 16), (40, 8, 2, 16), (10, 8, 2, 16), (320, 16, 2, 32), (31, 16, 2, 32),
])
def test_video_clip_starts_match_jax(total, frames, stride, step):
    assert fe.video_clip_starts(total, frames, stride, step) == jax_fe.video_clip_starts(
        total, frames, stride, step)


@pytest.mark.parametrize("n_clips,n_frames,per_clip", [(7, 120, 16), (10, 320, 32), (3, 96, 32),
                                                       (5, 7, 32)])
def test_frame_level_scores_match_jax(n_clips, n_frames, per_clip):
    s = np.random.default_rng(n_clips).uniform(0, 1, n_clips).astype(np.float32)
    np.testing.assert_array_equal(frame_level_scores(s, n_frames, per_clip),
                                  jax_frame_level_scores(s, n_frames, per_clip))


@pytest.mark.parametrize("shape", [(5, 64), (70, 2, 16)])
def test_feature_padding_matches_jax(shape):
    feats = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ours, ref = with_magnitude(feats), jax_with_magnitude(feats)
    np.testing.assert_array_equal(ours, ref)
    for a, b in zip(padded_test_batch(ours), jax_padded_test_batch(ref)):
        np.testing.assert_array_equal(a, b)


def test_native_reader_matches_jax(tmp_path):
    """The port's ctypes binding of native/videodec against the JAX package's, on a
    real container: strided reads, decoder-side resize, EOF padding."""
    from ted_spad_tpu.data.video_reader import open_video as jax_open_video
    from ted_spad_tpu.data.video_reader import write_y4m
    from ted_spad_tpu_torch.data.video_reader import VideoReader, open_video

    rng = np.random.default_rng(0)
    path = write_y4m(str(tmp_path / "v.y4m"), rng.integers(0, 256, (12, 24, 32, 3), np.uint8))
    for out_w, out_h in ((0, 0), (16, 12)):
        ours, ref = open_video(path, out_w, out_h), jax_open_video(path, out_w, out_h)
        assert isinstance(ours, VideoReader) and len(ours) == len(ref) == 12
        for start, n, stride in ((0, 4, 2), (5, 3, 1), (8, 6, 2)):  # the last runs past EOF
            np.testing.assert_array_equal(ours.read_strided(start, n, stride),
                                          ref.read_strided(start, n, stride))
        ours.close(), ref.close()
        with pytest.raises(IOError, match="closed"):
            ours.read_strided(0, 1, 1)


def test_dedup_names_match_jax():
    uris = ["/a/x.mp4", "/b/x.mp4", "/c/y.avi", "synthetic://n=10,h=4,w=4,seed=1"]
    assert dedup_names(uris) == jax_dedup_names(uris)


def test_spans_above_matches_the_jax_cli():
    sys.path.insert(0, ROOT)
    from scripts.score_video import spans_above as jax_spans_above

    for scores in ([0.1, 0.9, 0.9, 0.2, 0.8], [0.9, 0.9], [0.1], []):
        assert score_video.spans_above(scores, 0.5) == jax_spans_above(scores, 0.5)


@pytest.mark.parametrize("field,value", [("quant", "int8")])
def test_unported_options_raise(field, value, tmp_path):
    """Every extraction option is ported now, the int8 mode last (held against JAX in
    test_torch_port_quant.py). What the JAX stage refuses of it the port refuses too,
    in the same words: the int8 mode without the fa it quantizes, and a quant value
    neither package has."""
    p = FeatureExtractionParams(**{field: value}, num_frames=8, reso_h=32, reso_w=32,
                                compute_dtype="float32", anonymized=False)
    ft = load_ft_model(tiny=True, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="requires anonymized=True"):
        fe.extract_features(p, URIS[:1], str(tmp_path), ft=ft, device="cpu")
    with pytest.raises(ValueError, match="quant must be 'none' or 'int8'"):
        fe.make_extract_step(ft, p.replace(**{field: "int4"}), device="cpu")


def test_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = FeatureExtractionParams(num_frames=8, reso_h=32, reso_w=32, compute_dtype="float32")
    for call in (
        lambda: load_fa_model(tiny=True),
        lambda: load_ft_model(tiny=True),
        lambda: load_mgfn_model(MGFNParams(dims=(16, 32, 64), dim_head=16)),
        lambda: fe.extract_features(p, URIS[:1], str(tmp_path)),
        lambda: score_video.run(score_video.parser().parse_args(
            ["--synthetic", "--out_dir", str(tmp_path)])),
        lambda: train_anomaly_detection(MGFNParams(), save_dir=str(tmp_path)),
        lambda: train_mgfn.run(train_mgfn.parser().parse_args(
            ["--synthetic", "--save_dir", str(tmp_path)])),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    ft = load_ft_model(tiny=True, dtype="float32", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fe.make_extract_step(ft, p)
    mp = MGFNParams(dims=(16, 32, 64), dim_head=16)
    model = load_mgfn_model(mp, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_score_fn(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(model, make_optimizer(model, mp), mp)


def test_cuda_device_resolves_to_an_index(monkeypatch):
    """'cuda' names the current card, so it compares equal to the device tensors and
    modules report ('cuda:0'), as the step's device checks need."""
    from ted_spad_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax')]:\n"
        "    del sys.modules[m]\n"
        "for name in ('jax', 'flax', 'msgpack'):  # any import of them now fails\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, ted_spad_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(ted_spad_tpu_torch.__path__,"
        " 'ted_spad_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'ted_spad_tpu']\n"
        "assert not bad, bad\n"
        "print(' '.join(mods))\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    *_, names, count = out.stdout.strip().splitlines()
    assert int(count) >= 70
    slice7 = {"cli", "data.gt_builders", "extract_features", "make_gt", "models.i3d", "models.mvit",
              "models.r3d"}  # the extraction options' and gt builders' modules
    slice8 = {"ops.yuv", "ops.int8conv", "ops.fast_unetpp", "ops.quant_unetpp",
              "ops.quant_i3d"}  # YUV ingest and the int8 serving mode
    training = {"config.paths", "data.videos", "data.images", "stages.fa_pretraining",
                "stages.action_training", "train_reconstruction",
                "train_action"}  # fa pretraining and action training, with their CLIs
    privacy = {"stages.privacy_training", "stages.anonymization_training", "train_privacy",
               "train_anonymizer", "models.resnet2d", "ops.metrics", "utils.logging",
               "utils.checkpoint"}  # privacy training and the adversarial stage, with their CLIs
    visualization = {"stages.visualization", "visualize_anonymization",
                     "data.video_reader"}  # stage 4.5, its CLI and the encoder binding
    workflow = {"utils.torch_convert", "utils.reference_layout", "utils.model_size",
                "convert_weights", "profile_stage", "run_pipeline", "validate_adversarial",
                "run_parity"}  # seed conversion and the chained workflow, with their CLIs
    assert {f"ted_spad_tpu_torch.{m}" for m in
            slice7 | slice8 | training | privacy | visualization | workflow} <= set(names.split())


def test_score_video_cli_synthetic_on_cpu(tmp_path):
    """The serving CLI end to end; its frame scores equal direct scoring of the
    features it extracted with the same seeded MGFN."""
    args = score_video.parser().parse_args(
        ["--synthetic", "--device", "cpu", "--out_dir", str(tmp_path), "--num_workers", "2"])
    summaries = score_video.run(args)
    assert len(summaries) == 2 and all("error" not in s for s in summaries)
    mp = MGFNParams.for_dataset("UCF").replace(dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16)
    score_fn = make_score_fn(load_mgfn_model(mp, device="cpu"), device="cpu")
    [feat_dir] = [d for d in (tmp_path / "features").iterdir()]
    for s in summaries:
        frames = np.load(s["scores"])
        assert s["clips"] == 7 and s["frames"] == 120 == len(frames)
        assert np.all((frames >= 0) & (frames <= 1))
        video, mask, t = padded_test_batch(with_magnitude(
            np.load(feat_dir / os.path.basename(s["scores"]))))
        direct = frame_level_scores(score_fn(video, mask)[0, :t].numpy(), 120, frames_per_clip=16)
        np.testing.assert_allclose(frames, direct, rtol=1e-6, atol=1e-7)
    on_disk = json.load(open(tmp_path / "summary.json"))
    assert on_disk["threshold"] == 0.5 and len(on_disk["videos"]) == 2
