"""Port parity for the MGFN anomaly stage as a whole: the feature datasets and
batching, the frame-level metrics, the bucketed evaluation, the training loop end to
end (its final checkpoint read and evaluated by the JAX package), and the CLIs on
the CPU (``train_mgfn``, ``score_video`` with checkpoints the JAX package wrote).

Small widths (feature 64, dims (16, 32, 64), depths (1, 1, 1), dim_head 16, 4 videos
per half), float32 on the CPU, inputs from numpy seeds. Tolerances per test."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from sklearn.metrics import average_precision_score, auc, precision_recall_curve, roc_auc_score

import jax

import ted_spad_tpu.data.features as jax_fm
from ted_spad_tpu.config.params import MGFNParams as JaxMGFNParams
from ted_spad_tpu.models import load_mgfn_model as jax_load_mgfn
from ted_spad_tpu.ops import metrics as jax_metrics
from ted_spad_tpu.ops.temporal import segment_train_features as jax_segment_train_features
from ted_spad_tpu.stages.anomaly_detection import evaluate as jax_evaluate
from ted_spad_tpu.stages.anomaly_detection import make_score_fn as jax_make_score_fn
from ted_spad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
import ted_spad_tpu_torch.data.features as fm
from ted_spad_tpu_torch import score_video, train_mgfn
from ted_spad_tpu_torch.config.params import MGFNParams
from ted_spad_tpu_torch.data.prefetch import prefetch
from ted_spad_tpu_torch.models import load_fa_model, load_ft_model, load_mgfn_model
from ted_spad_tpu_torch.ops import metrics
from ted_spad_tpu_torch.ops.temporal import segment_train_features
from ted_spad_tpu_torch.stages.anomaly_detection import (
    evaluate, make_score_fn, train_anomaly_detection,
)
from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables, state_dict_to_flax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(feature_size=64, dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16, batch_size=4)


def perturbed(variables, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32) * rng.uniform(0.8, 1.2, np.shape(x))
                   + 0.05 * rng.standard_normal(np.shape(x))).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, variables))


def write_features(root, lengths, *, ncrops=None, f=64, seed=0, prefix="v"):
    """One .npy per length ((T, F) or (T, ncrops, F)); every other one carries a
    planted span. Returns (paths, frame gt at 32 frames per clip)."""
    rng = np.random.default_rng(seed)
    paths, gts = [], []
    for i, t in enumerate(lengths):
        x = rng.standard_normal((t, f) if ncrops is None else (t, ncrops, f)).astype(np.float32)
        m = np.zeros(t, np.float32)
        if i % 2 == 0:
            s = int(rng.integers(0, t - 4))
            x[s:s + 4] *= 5.0
            m[s:s + 4] = 1.0
        path = os.path.join(root, f"{prefix}{i}.npy")
        np.save(path, x)
        paths.append(path)
        gts.append(np.repeat(m, 32))
    return paths, np.concatenate(gts)


def write_list(path, paths) -> str:
    with open(path, "w") as f:
        f.write("\n".join(paths) + "\n")
    return str(path)


# ---------------------------------------------------------------------------
# Datasets and batching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 8), (32, 8), (77, 8), (45, 3, 8), (1, 4)])
def test_segment_train_features_match_jax(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(segment_train_features(x), jax_segment_train_features(x))


@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True), (True, False)])
def test_feature_datasets_and_batches_match_jax(tmp_path, monkeypatch, shuffle, drop_last):
    """FeatureDataset / TestFeatureDataset (items, names, peek_shape) and
    paired_train_batches, with a split that leaves the halves unequal: exact."""
    paths, _ = write_features(str(tmp_path), [20, 70, 33, 90, 41, 12, 64, 50, 81, 37, 29],
                              seed=1)
    train = write_list(tmp_path / "train.list", [os.path.basename(p) for p in paths])
    for module in (fm, jax_fm):
        monkeypatch.setitem(module.ABNORMAL_SPLIT, "UCF", 4)
    kw = dict(datasetname="UCF", seg_length=32, root=str(tmp_path))
    for is_normal in (True, False):
        ours = fm.FeatureDataset(train, is_normal=is_normal, **kw)
        ref = jax_fm.FeatureDataset(train, is_normal=is_normal, **kw)
        assert len(ours) == len(ref) == (7 if is_normal else 4)
        for i in range(len(ref)):
            (a, la), (b, lb) = ours[i], ref[i]
            np.testing.assert_array_equal(a, b)
            assert la == lb == (0.0 if is_normal else 1.0)
    mk = lambda mod: [mod.FeatureDataset(train, is_normal=n, **kw) for n in (True, False)]
    ours = list(fm.paired_train_batches(*mk(fm), 3, shuffle=shuffle, seed=4, drop_last=drop_last))
    ref = list(jax_fm.paired_train_batches(*mk(jax_fm), 3, shuffle=shuffle, seed=4,
                                           drop_last=drop_last))
    assert len(ours) == len(ref) == (1 if drop_last else 2)
    for a, b in zip(ours, ref):
        assert a[0].shape[0] == a[2].shape[0]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    test = write_list(tmp_path / "test.list", paths[:5])
    ours, ref = fm.TestFeatureDataset(test), jax_fm.TestFeatureDataset(test)
    for i in range(5):
        assert ours.peek_shape(i) == ref.peek_shape(i)
        (a, na), (b, nb) = ours[i], ref[i]
        np.testing.assert_array_equal(a, b)
        assert na == nb == f"v{i}"


def test_step_timer_and_metrics_writer(tmp_path):
    from ted_spad_tpu_torch.utils.logging import MetricsWriter, StepTimer

    timer = StepTimer(window=3)
    assert timer.rate(4) == 0.0
    for _ in range(5):
        assert timer.tick() >= 0.0
    assert len(timer._times) == 3 and timer.rate(4) == pytest.approx(4 / timer.mean_step_s())
    w = MetricsWriter(str(tmp_path), "run")
    w.scalars({"loss": 0.5, "roc_auc": float("nan")}, 3)
    w.text("note", "hello")
    w.close()
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [(r["tag"], r["step"]) for r in rows] == [("loss", 3), ("roc_auc", 3)]
    assert rows[0]["value"] == 0.5 and np.isnan(rows[1]["value"])
    assert (tmp_path / "run" / "note.txt").read_text() == "hello"


def test_prefetch_order_errors_and_early_close():
    with prefetch(iter(range(57)), depth=3) as it:
        assert list(it) == list(range(57))

    def failing():
        yield 1
        raise RuntimeError("load failed")

    with prefetch(failing()) as it:
        assert next(it) == 1
        with pytest.raises(RuntimeError, match="load failed"):
            next(it)
        with pytest.raises(StopIteration):
            next(it)

    state = {"produced": 0, "closed": False}

    def endless():
        try:
            for i in range(10_000):
                state["produced"] = i + 1
                yield i
        finally:
            state["closed"] = True

    it = prefetch(endless(), depth=2)
    assert next(it) == 0
    it.close()
    assert state["closed"] and state["produced"] <= 4


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_metrics_match_jax_and_sklearn(seed, ties):
    """ROC AUC, PR AUC (trapezoidal over sklearn's PR curve) and AP against the JAX
    package and sklearn: 1e-12; the curves against JAX exactly."""
    rng = np.random.default_rng(seed)
    labels = (rng.uniform(size=3000) < 0.2).astype(np.float32)
    scores = rng.uniform(size=3000).astype(np.float32)
    if ties:
        scores = np.round(scores * 20) / 20
    scores = scores + 0.3 * labels * rng.uniform(size=3000)
    p, r, _ = precision_recall_curve(labels, scores)
    for ours, ref, sk in (
        (metrics.roc_auc(labels, scores), jax_metrics.roc_auc(labels, scores),
         roc_auc_score(labels, scores)),
        (metrics.pr_auc(labels, scores), jax_metrics.pr_auc(labels, scores), auc(r, p)),
        (metrics.average_precision(labels, scores), jax_metrics.average_precision(labels, scores),
         average_precision_score(labels, scores)),
    ):
        assert abs(ours - ref) <= 1e-12 and abs(ours - sk) <= 1e-12, (ours, ref, sk)
    for ours, ref in ((metrics.roc_curve(labels, scores), jax_metrics.roc_curve(labels, scores)),
                      (metrics.precision_recall_curve(labels, scores),
                       jax_metrics.precision_recall_curve(labels, scores))):
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ncrops", [None, 10])
def test_evaluate_matches_jax(tmp_path, ncrops):
    """Bucketed, batched evaluation (eval_batch 8; lengths in buckets 64, 128 and 192;
    one bucket holds more than one chunk, so chunks are padded) on the same weights
    and test set as the JAX package's evaluate: |dAUC| <= 1e-6."""
    lengths = [20, 130, 64, 65, 150, 40, 31, 127, 50, 63, 11, 100, 60, 55, 45, 35, 25]
    paths, gt = write_features(str(tmp_path), lengths, ncrops=ncrops, seed=3)
    test_list = write_list(tmp_path / "test.list", paths)
    jp = JaxMGFNParams.for_dataset("UCF").replace(**SMALL)
    jmodel, jvars = jax_load_mgfn(jp, ncrops=ncrops or 1)
    jvars = perturbed(jvars, 5)
    ref = jax_evaluate(jax_make_score_fn(jmodel), jvars, jax_fm.TestFeatureDataset(test_list), gt,
                       eval_batch=8, frames_per_clip=32)
    model = load_jax_variables(
        load_mgfn_model(MGFNParams.for_dataset("UCF").replace(**SMALL), device="cpu"), jvars)
    ours = evaluate(make_score_fn(model, device="cpu"), fm.TestFeatureDataset(test_list), gt,
                    eval_batch=8, frames_per_clip=32)
    assert 0.0 < ref[0] < 1.0 and 0.0 < ref[1] < 1.0
    assert abs(ours[0] - ref[0]) <= 1e-6 and abs(ours[1] - ref[1]) <= 1e-6, (ours, ref)


# ---------------------------------------------------------------------------
# The training loop and the CLIs
# ---------------------------------------------------------------------------


def test_train_anomaly_detection_end_to_end(tmp_path, monkeypatch):
    """Two epochs on synthetic features on the CPU: history, best and final
    checkpoints, metrics.jsonl and the best record are there; the JAX package's
    load_mgfn_model reads the final checkpoint and its evaluate gives the port's
    last AUCs within 1e-6."""
    root = tmp_path / "data"
    root.mkdir()
    train_list, test_list, gt = train_mgfn.write_synthetic_features(
        str(root), n_train=16, n_test=6, feature_size=64, clips=(40, 80), frames_per_clip=32,
        seed=0)
    monkeypatch.setitem(fm.ABNORMAL_SPLIT, "UCF", 8)
    p = MGFNParams.for_dataset("UCF").replace(**SMALL, rgb_list=train_list,
                                              test_rgb_list=test_list, dropout_rate=0.3,
                                              model_name="mgfn_synth", lr_schedule=(1e-3, 5e-4))
    logs = []
    save_dir = str(tmp_path / "ckpt")
    res = train_anomaly_detection(p, save_dir=save_dir, gt=gt, max_epochs=2, log_fn=logs.append,
                                  device="cpu")
    h = res["history"]
    assert h["epoch"] == [1, 2] and len(h["test_AUC"]) == len(h["test_PR"]) == len(logs) == 2
    assert all(np.isfinite(h["loss"])) and res["best_metric"] == max(h["test_AUC"])
    assert os.path.exists(res["best_path"]) and os.path.exists(res["final_path"])
    assert os.path.basename(res["best_path"]).startswith("mgfn_synth_")
    with open(os.path.join(save_dir, "mgfn_synth", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert sorted({r["tag"] for r in rows}) == ["loss", "pr_auc", "roc_auc"] and len(rows) == 6
    assert os.path.exists(os.path.join(save_dir, "mgfn_synth", "best_record_epoch_1.txt"))
    assert not [f for f in os.listdir(save_dir) if f.endswith(".tmp")]

    jp = JaxMGFNParams.for_dataset("UCF").replace(**SMALL, dropout_rate=0.3)
    jmodel, jvars = jax_load_mgfn(jp, saved_model_file=res["final_path"], ncrops=1)
    roc, pr = jax_evaluate(jax_make_score_fn(jmodel), jvars, jax_fm.TestFeatureDataset(test_list),
                           gt, frames_per_clip=32)
    assert abs(roc - h["test_AUC"][-1]) <= 1e-6 and abs(pr - h["test_PR"][-1]) <= 1e-6


def test_train_mgfn_cli_and_test_only_on_cpu(tmp_path, monkeypatch):
    """``python -m ted_spad_tpu_torch.train_mgfn --synthetic --device cpu`` trains and
    writes its checkpoints; ``--test_only`` on its final checkpoint (same seed, so the
    same synthetic test set) reproduces the last epoch's AUCs."""
    out = subprocess.run(
        [sys.executable, "-m", "ted_spad_tpu_torch.train_mgfn", "--synthetic", "--device", "cpu",
         "--epochs", "2", "--save_dir", str(tmp_path)],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("done; best") and lines[1].startswith("epoch 2:")
    last = lines[1].split()
    assert os.path.exists(tmp_path / "mgfn_synth_final.ckpt")

    monkeypatch.setitem(fm.ABNORMAL_SPLIT, "UCF", fm.ABNORMAL_SPLIT["UCF"])  # restored after
    res = train_mgfn.run(train_mgfn.parser().parse_args(
        ["--synthetic", "--device", "cpu", "--test_only", str(tmp_path / "mgfn_synth_final.ckpt")]))
    assert f"{res['roc_auc']:.4f}" == last[last.index("roc_auc") + 1]
    assert f"{res['pr_auc']:.4f}" == last[last.index("pr_auc") + 1]


def test_score_video_reads_jax_checkpoints(tmp_path):
    """score_video with --saved_model_fa / --saved_model_ft / --mgfn_ckpt files that
    the JAX package's save_checkpoint wrote (the ft one with a 102-class classifier,
    as action training writes it, whose width load_ft_model takes from the file)
    gives the same scores as the same weights through the .npz flags."""
    rng = np.random.default_rng(0)

    def moved(tree):
        return jax.tree_util.tree_map(
            lambda x: (x * rng.uniform(0.9, 1.1, x.shape)).astype(np.float32), tree)

    fa = moved(state_dict_to_flax(load_fa_model(dtype="float32", device="cpu", seed=3)))
    ft = moved(state_dict_to_flax(load_ft_model(dtype="float32", device="cpu", seed=4)))
    mp = MGFNParams.for_dataset("UCF").replace(dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16)
    mg = moved(state_dict_to_flax(load_mgfn_model(mp, device="cpu")))
    ft_ckpt = {**ft, "params": {**ft["params"], "i3d": {**ft["params"]["i3d"], "fc": {
        "kernel": np.ones((2048, 102), np.float32), "bias": np.zeros(102, np.float32)}}}}
    ckpts, npzs = {}, {}
    for name, key, tree, ckpt_tree in (("fa", "fa_model_state_dict", fa, fa),
                                       ("ft", "ft_model_state_dict", ft, ft_ckpt),
                                       ("mgfn", "mgfn_model_state_dict", mg, mg)):
        ckpts[name] = jax_save_checkpoint(str(tmp_path / f"{name}.ckpt"),
                                          {key: ckpt_tree, "epoch": 5})
        npzs[name] = str(tmp_path / f"{name}.npz")
        np.savez(npzs[name], **{"/".join(k.key for k in path): v for path, v in
                                jax.tree_util.tree_flatten_with_path(tree)[0]})
    common = ["--synthetic", "--device", "cpu", "--num_workers", "2"]
    by_ckpt = score_video.run(score_video.parser().parse_args(common + [
        "--out_dir", str(tmp_path / "a"), "--saved_model_fa", ckpts["fa"],
        "--saved_model_ft", ckpts["ft"], "--mgfn_ckpt", ckpts["mgfn"]]))
    by_npz = score_video.run(score_video.parser().parse_args(common + [
        "--out_dir", str(tmp_path / "b"), "--fa_weights", npzs["fa"],
        "--ft_weights", npzs["ft"], "--mgfn_weights", npzs["mgfn"]]))
    random_init = score_video.run(score_video.parser().parse_args(common + [
        "--out_dir", str(tmp_path / "c")]))
    assert len(by_ckpt) == len(by_npz) == 2
    for a, b, c in zip(by_ckpt, by_npz, random_init):
        np.testing.assert_array_equal(np.load(a["scores"]), np.load(b["scores"]))
        assert not np.array_equal(np.load(a["scores"]), np.load(c["scores"]))
