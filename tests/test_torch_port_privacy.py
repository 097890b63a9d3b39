"""Parity of the port's privacy side with ted_spad_tpu's, on the CPU: the cMAP and
P/R/F1 metrics, the VISPR source and batches (jpgs and a labels pickle written
here), the fb models (Bottleneck2D, ResNet50Classifier, ResNet50SSL) in train and
eval mode, load_fb_model's checkpoints both ways, one whole privacy step (plain and
through the frozen fa) from bridged weights, the eval step, and the privacy driver
in both packages (histories, checkpoints that cross-load, a failing epoch). Also
BestCheckpointer's threshold mode, config_dump and K2's gradient guard. float32,
torch on one thread; the limits are stated at each test."""

from __future__ import annotations

import functools
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_train_stages import as_port_draw, bridged, check_step, flat, rel

from ted_spad_tpu.config.params import PrivacyParams as JaxPrivacyParams
from ted_spad_tpu.data import images as jax_images
from ted_spad_tpu.models import load_fa_model as jax_load_fa
from ted_spad_tpu.models import load_fb_model as jax_load_fb
from ted_spad_tpu.models.resnet2d import Bottleneck2D as JaxBottleneck2D
from ted_spad_tpu.ops import augment as jax_augment
from ted_spad_tpu.ops import losses as jax_losses
from ted_spad_tpu.ops import metrics as jax_metrics
from ted_spad_tpu.ops.fast_unetpp import make_fast_fa_apply
from ted_spad_tpu.stages import privacy_training as jax_privacy
from ted_spad_tpu.stages.common import make_optimizer as jax_make_optimizer
from ted_spad_tpu.utils import checkpoint as jax_checkpoint
from ted_spad_tpu_torch.config.params import PrivacyParams
from ted_spad_tpu_torch.data import images
from ted_spad_tpu_torch.models import load_fa_model, load_fb_model
from ted_spad_tpu_torch.models.resnet2d import Bottleneck2D
from ted_spad_tpu_torch.ops import metrics
from ted_spad_tpu_torch.ops.doubleconv import refuse_grad
from ted_spad_tpu_torch.stages import privacy_training
from ted_spad_tpu_torch.stages.common import make_optimizer
from ted_spad_tpu_torch.utils import checkpoint
from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax
from ted_spad_tpu_torch.utils.logging import MetricsWriter, config_dump

torch.set_num_threads(1)

OUT_RTOL = 1e-4     # fb outputs, ||d|| / ||ref||
STATS_RTOL = 1e-5   # running statistics after a train-mode forward, per tensor
SIDE = 32


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_cmap_and_prf1_exact(seed):
    """cMAP with its per-class AP and macro P/R/F1 equal JAX's exactly, with tied
    scores and a class without positives (AP 0)."""
    rng = np.random.default_rng(seed)
    labels = (rng.random((40, 7)) < 0.3).astype(np.float32)
    labels[:, 3] = 0.0  # no positives
    scores = np.round(rng.random((40, 7)), 1).astype(np.float32)  # ties
    cmap, per_class = metrics.macro_average_precision(labels, scores)
    jcmap, jper = jax_metrics.macro_average_precision(labels, scores)
    assert cmap == jcmap and per_class[3] == 0.0
    np.testing.assert_array_equal(per_class, jper)
    assert metrics.multilabel_prf1(labels, scores) == jax_metrics.multilabel_prf1(labels, scores)
    assert metrics.multilabel_prf1(labels, scores, 0.3) == jax_metrics.multilabel_prf1(labels, scores, 0.3)


# ---------------------------------------------------------------------------
# VISPR data
# ---------------------------------------------------------------------------


def _vispr_folder(root, n: int = 10) -> tuple[str, str]:
    """``n`` PIL-written jpgs of varied sizes (one grayscale) and their labels pickle."""
    from PIL import Image

    rng = np.random.default_rng(3)
    data = os.path.join(root, "train2017")
    os.makedirs(data)
    labels = {}
    for i in range(n):
        h, w = (int(v) for v in rng.integers(40, 90, 2))
        if i == 2:
            Image.fromarray(rng.integers(0, 256, (h, w), np.uint8), "L").save(os.path.join(data, f"im{i:03d}.jpg"))
        else:
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(os.path.join(data, f"im{i:03d}.jpg"))
        labels[f"im{i:03d}"] = (rng.random(7) < 0.4).astype(np.float32)
    pkl = os.path.join(root, "train_labels.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(labels, f)
    return data, pkl


def _same_batch(a, b) -> None:
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    for pa, pb in ((a.params, b.params), (a.params2, b.params2)):
        assert (pa is None) == (pb is None)
        if pa is not None:
            for k in type(pa).__dataclass_fields__:
                np.testing.assert_array_equal(getattr(pa, k), getattr(pb, k), err_msg=k)


def test_vispr_source_and_batches_exact(tmp_path):
    """VisprImageSource (shuffle, data_percentage, grayscale jpg) and vispr_batches
    (train, SSL pair with the shared crop origin, eval without dropping the tail)
    give JAX's images, labels and draws exactly; boring_video_batch too."""
    data, pkl = _vispr_folder(str(tmp_path))
    assert images.load_vispr_labels(pkl).keys() == jax_images.load_vispr_labels(pkl).keys()
    for kw in (dict(seed=5, data_percentage=0.8, canonical=48), dict(shuffle=False, canonical=40)):
        ours, ref = images.VisprImageSource(data, pkl, **kw), jax_images.VisprImageSource(data, pkl, **kw)
        assert ours.paths == ref.paths and len(ours) == len(ref)
        got, want = ours.get_batch([0, 2, 1]), ref.get_batch([0, 2, 1])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        for bkw in (dict(train=True), dict(train=True, ssl=True), dict(train=False, drop_last=False)):
            a = list(images.vispr_batches(ours, 3, out_h=SIDE, out_w=SIDE, seed=2, **bkw))
            b = list(jax_images.vispr_batches(ref, 3, out_h=SIDE, out_w=SIDE, seed=2, **bkw))
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                _same_batch(x, y)
            if bkw.get("ssl"):
                np.testing.assert_array_equal(np.minimum(a[0].params.y0, a[0].params2.y0), a[0].params2.y0)
    clip = images.boring_video_batch(got[0], 5)
    np.testing.assert_array_equal(clip, jax_images.boring_video_batch(got[0], 5))
    assert clip.shape == (3, 5) + got[0].shape[1:]


# ---------------------------------------------------------------------------
# fb models
# ---------------------------------------------------------------------------


def _close(got: torch.Tensor, want) -> None:
    assert rel(got.detach().double().numpy(), want) <= OUT_RTOL


def _stats_close(module, jstats) -> None:
    got, want = flat(state_dict_to_flax(module)["batch_stats"]), flat(jstats)
    assert got.keys() == want.keys()
    for k in want:
        assert rel(got[k], want[k]) <= STATS_RTOL, k


@pytest.mark.parametrize("model", ["bottleneck", "classifier", "ssl"])
def test_fb_models_match_jax(model):
    """Bottleneck2D (strided, with its downsample), the tiny ResNet50Classifier and
    ResNet50SSL from bridged weights: eval outputs, then train-mode outputs and the
    running statistics they moved."""
    rng = np.random.default_rng(1)
    g = torch.Generator().manual_seed(0)
    if model == "bottleneck":
        port = Bottleneck2D(16, 8, 2, True, generator=g)
        jmodel = JaxBottleneck2D(8, 2, True)
        x = rng.standard_normal((3, 12, 12, 16)).astype(np.float32)
        jvars = jmodel.init(jax.random.PRNGKey(0), x)
    else:
        ssl = model == "ssl"
        port = load_fb_model(ssl=ssl, tiny=True, dtype="float32", device="cpu")
        jmodel, jvars = jax_load_fb(ssl=ssl, tiny=True, image_size=(SIDE, SIDE), dtype="float32")
        x = rng.random((3, SIDE, SIDE, 3)).astype(np.float32)
    port, tree = bridged(port, 2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = port(xt)
    _close(out.permute(0, 2, 3, 1) if out.dim() == 4 else out, jmodel.apply(tree, x))
    jout, mutated = jmodel.apply(tree, x, train=True, mutable=["batch_stats"])
    out = port(xt, train=True)
    _close(out.permute(0, 2, 3, 1) if out.dim() == 4 else out, jout)
    _stats_close(port, mutated["batch_stats"])
    if model == "ssl":
        np.testing.assert_allclose(torch.linalg.norm(out, dim=-1).detach().numpy(), 1.0, rtol=1e-6)


def test_fb_checkpoints_cross_load(tmp_path):
    """An fb checkpoint written by either package loads in the other package's
    load_fb_model bit-exactly; the classifier and the SSL model are distinct trees."""
    port, tree = bridged(load_fb_model(tiny=True, dtype="float32", device="cpu"), 4)
    ours = checkpoint.save_checkpoint(str(tmp_path / "p.ckpt"), {"fb_model_state_dict": state_dict_to_flax(port)})
    theirs = str(tmp_path / "j.ckpt")
    jax_checkpoint.save_checkpoint(theirs, {"fb_model_state_dict": jax.tree_util.tree_map(jnp.asarray, tree)})
    jax_checkpoint.flush_checkpoints()
    for path in (ours, theirs):
        got = load_fb_model(saved_model_file=path, tiny=True, dtype="float32", device="cpu")
        _, jvars = jax_load_fb(saved_model_file=path, tiny=True, image_size=(SIDE, SIDE), dtype="float32")
        a, b = flat(state_dict_to_flax(got)), flat(jax.tree_util.tree_map(np.asarray, jvars))
        assert a.keys() == b.keys() == flat(tree).keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(KeyError):
        load_fb_model(saved_model_file=ours, ssl=True, tiny=True, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="r50"):
        load_fb_model("r18", device="cpu")


# ---------------------------------------------------------------------------
# Privacy steps
# ---------------------------------------------------------------------------


def _privacy_batch(n: int = 8):
    src = images.SyntheticImageSource(n=n, seed=3, canonical=40)
    imgs, labels = src.get_batch(list(range(n)))
    labels[0, :2] = [1.0, 0.0]  # both label values in the first columns
    draw = jax_images.sample_image_augment_params(np.random.default_rng(6), n, 40, SIDE, SIDE)
    draw.do_hue[:2] = True
    return imgs, labels, draw


@pytest.mark.parametrize("anon", [False, True])
def test_privacy_step_matches_jax(anon):
    """One privacy step (augment -> [frozen fa] -> fb in train mode -> BCE -> Adam)
    from bridged weights on the same images, labels and draw: the loss (1e-5
    relative), every gradient (1e-4), the parameters after Adam (1e-3 of the update)
    and the running statistics (1e-5); then the eval step's loss and scores. Eight
    images: the tiny fb's last stage is 1x1 at 32^2, and with four images its
    train-mode BN normalizes over four numbers, which amplifies float32 rounding to
    2e-4 of a gradient in both packages (8 images: 2e-5)."""
    fb, tree = bridged(load_fb_model(tiny=True, dtype="float32", device="cpu").requires_grad_(True), 7)
    jfb = jax_load_fb(tiny=True, image_size=(SIDE, SIDE), dtype="float32")[0]
    fa = fa_apply = None
    if anon:
        fa, fa_tree = bridged(load_fa_model(tiny=True, dtype="float32", device="cpu"), 8)
        jfa = jax_load_fa(image_size=(SIDE, SIDE), dtype="float32", tiny=True)[0]
        fa_vars = jax.tree_util.tree_map(jnp.asarray, fa_tree)
        fast = make_fast_fa_apply(jfa, fa_vars)
        fa_apply = lambda img: fast(fa_vars, img, train=False)  # noqa: E731
    imgs, labels, draw = _privacy_batch()

    def loss_fn(params):
        img = jax_augment.augment_batch(jnp.asarray(imgs)[:, None], draw.to_device(), SIDE, SIDE)[:, 0]
        if fa_apply is not None:
            img = jax.lax.stop_gradient(fa_apply(img))
        logits, _ = jfb.apply({**tree, "params": params}, img, train=True, mutable=["batch_stats"])
        return jax_losses.bce_with_logits_loss(logits, labels)

    jgrads = flat(jax.jit(jax.grad(loss_fn))(tree["params"]))
    optimizer = jax_make_optimizer("adam", 1e-3)
    jtrain, jeval = jax_privacy.make_steps(jfb, fa_apply, optimizer, (SIDE, SIDE))
    state = jax.tree_util.tree_map(jnp.asarray, tree)
    new, _, jloss = jtrain(state, optimizer.init(state["params"]), jnp.asarray(imgs), jnp.asarray(labels),
                           draw.to_device())
    new = jax.tree_util.tree_map(np.asarray, new)

    train_step, eval_step = privacy_training.make_steps(
        fb, fa, make_optimizer(fb.parameters(), "adam", 1e-3), (SIDE, SIDE), compute_dtype="float32",
        device="cpu")
    loss = train_step(imgs, labels, as_port_draw(draw))
    check_step(fb, loss, jloss, jgrads, flat(tree["params"]), new["params"], new["batch_stats"])
    if fa is not None:
        assert all(q.grad is None for q in fa.parameters())

    vloss, scores = eval_step(imgs, labels)
    jvloss, jscores = jeval(jax.tree_util.tree_map(jnp.asarray, new), jnp.asarray(imgs), jnp.asarray(labels))
    assert abs(float(vloss) - float(jvloss)) <= 1e-5 * abs(float(jvloss))
    assert scores.dtype == torch.float32
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# The privacy driver
# ---------------------------------------------------------------------------


def test_privacy_driver_matches_jax_and_cross_loads(tmp_path, monkeypatch):
    """A 1-epoch synthetic anonymized run of train_privacy in each package: the same
    history keys and lengths, finite losses and cMAP in [0, 1]; the best checkpoint
    holds the scores, ground truth and per-class AP, and each package's fb loads in
    the other's load_fb_model; a failing epoch is logged, skipped and NaN-padded."""
    monkeypatch.setattr(jax_privacy, "load_fb_model", functools.partial(jax_load_fb, tiny=True))
    monkeypatch.setattr(jax_privacy, "load_fa_model", functools.partial(jax_load_fa, tiny=True))
    monkeypatch.setattr(privacy_training, "load_fb_model", functools.partial(load_fb_model, tiny=True))
    monkeypatch.setattr(privacy_training, "load_fa_model", functools.partial(load_fa_model, tiny=True))
    quiet = dict(log_fn=lambda s: None)
    kw = dict(run_id="priv", anon=True, reso_h=SIDE, reso_w=SIDE, batch_size=4, v_batch_size=3,
              compute_dtype="float32")
    src = dict(train_source=images.SyntheticImageSource(n=8, canonical=40),
               val_source=images.SyntheticImageSource(n=5, seed=1, canonical=40), max_epochs=1)
    ours = privacy_training.train_privacy(PrivacyParams(**kw), save_dir=str(tmp_path / "p"), device="cpu",
                                          **src, **quiet)
    ref = jax_privacy.train_privacy(JaxPrivacyParams(**kw), save_dir=str(tmp_path / "j"), **src, **quiet)
    shape = {k: len(v) for k, v in ours["history"].items()}
    assert shape == {k: len(v) for k, v in ref["history"].items()} == dict.fromkeys(ref["history"], 1)
    assert np.isfinite([v[0] for v in ours["history"].values()]).all()
    assert 0 <= ours["best_cmap"] <= 1
    state = checkpoint.load_checkpoint(ours["best_path"])
    assert state["prediction_scores"].shape == state["ground_truth"].shape == (5, 7)
    assert state["per_class_ap"].shape == (7,) and float(state["per_class_ap"].mean()) == pytest.approx(ours["best_cmap"])
    assert checkpoint.load_checkpoint(str(tmp_path / "p" / "priv" / "model_temp.ckpt"))["epoch"] == 2
    for path in (ours["best_path"], ref["best_path"]):
        port_fb = load_fb_model(saved_model_file=path, tiny=True, dtype="float32", device="cpu")
        _, jvars = jax_load_fb(saved_model_file=path, tiny=True, image_size=(SIDE, SIDE), dtype="float32")
        a, b = flat(state_dict_to_flax(port_fb)), flat(jax.tree_util.tree_map(np.asarray, jvars))
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    class Flaky:  # the second epoch's validation fails
        calls = 0

        def __len__(self):
            return 5

        def get_batch(self, idx):
            Flaky.calls += 1
            if Flaky.calls > 2:
                raise IOError("corrupt image")
            return src["val_source"].get_batch(idx)

    logs = []
    res = privacy_training.train_privacy(
        PrivacyParams(**kw), train_source=src["train_source"], val_source=Flaky(),
        save_dir=str(tmp_path / "f"), max_epochs=2, log_fn=logs.append, device="cpu")
    h = res["history"]
    assert any("epoch 2 failed; continuing" in m and "corrupt image" in m for m in logs)
    assert {k: len(v) for k, v in h.items()} == dict.fromkeys(h, 2)
    assert np.isfinite(h["train_loss"]).all() and np.isnan(h["cmap"][1]) and np.isfinite(h["cmap"][0])


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def test_best_checkpointer_threshold_and_config_dump(tmp_path):
    """With a threshold every qualifying epoch is saved and best_path follows the best,
    as JAX's BestCheckpointer; without one only improvements. config_dump writes one
    line per field."""
    for threshold, values, n_saved in ((0.5, [0.7, 0.6, 0.4, 0.8], 3), (None, [0.7, 0.6, 0.4, 0.8], 2)):
        ours = checkpoint.BestCheckpointer(str(tmp_path / f"p{threshold}"), "m", threshold=threshold)
        ref = jax_checkpoint.BestCheckpointer(str(tmp_path / f"j{threshold}"), "m", threshold=threshold)
        saved = [ours.maybe_save(v, e, {"x": np.zeros(2)}) for e, v in enumerate(values, 1)]
        jsaved = [ref.maybe_save(v, e, {"x": np.zeros(2)}) for e, v in enumerate(values, 1)]
        assert [s is None for s in saved] == [s is None for s in jsaved]
        assert sum(s is not None for s in saved) == n_saved
        assert ours.best == ref.best == 0.8 and os.path.basename(ours.best_path) == os.path.basename(ref.best_path)
    checkpoint.flush_checkpoints()
    writer = MetricsWriter(str(tmp_path), "cfg")
    config_dump(writer, PrivacyParams(anon=True))
    writer.close()
    text = open(os.path.join(str(tmp_path), "cfg", "config.txt")).read().splitlines()
    assert "anon: True" in text and len(text) == len(PrivacyParams.__dataclass_fields__)


def test_k2_refuses_to_cut_a_gradient():
    """K2's guard (the check fused_double_conv makes on a CUDA tensor before it
    launches): it raises under grad mode when any input requires grad, and passes
    under no_grad, inference_mode, or with inputs that need no gradient."""
    x = torch.zeros(1, 4, 4, 3)
    w = torch.zeros(3, 3, 3, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad(x, w)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad(x.clone().requires_grad_(True), w.detach())
    with torch.no_grad():
        refuse_grad(x, w)
    with torch.inference_mode():
        refuse_grad(x, w)
    refuse_grad(x, w.detach())


def test_clis_run_synthetic_on_cpu(tmp_path, monkeypatch, capsys):
    """Both new CLIs end to end with --synthetic --device cpu (tiny models): the privacy
    attack through the fa (--anon) and the adversarial stage; each writes its best
    checkpoint and prints its summary."""
    from ted_spad_tpu_torch import train_anonymizer, train_privacy
    from ted_spad_tpu_torch.models import load_ft_model
    from ted_spad_tpu_torch.stages import anonymization_training

    monkeypatch.setattr(privacy_training, "load_fb_model", functools.partial(load_fb_model, tiny=True))
    monkeypatch.setattr(privacy_training, "load_fa_model", functools.partial(load_fa_model, tiny=True))
    for name, fn in (("load_fa_model", load_fa_model), ("load_fb_model", load_fb_model),
                     ("load_ft_model", load_ft_model)):
        monkeypatch.setattr(anonymization_training, name, functools.partial(fn, tiny=True))
    res = train_privacy.run(train_privacy.parser().parse_args(
        ["--synthetic", "--device", "cpu", "--epochs", "1", "--anon", "--save_dir", str(tmp_path / "tp")]))
    assert os.path.exists(res["best_path"]) and "best cMAP" in capsys.readouterr().out
    res = train_anonymizer.run(train_anonymizer.parser().parse_args(
        ["--synthetic", "--device", "cpu", "--epochs", "1", "--save_dir", str(tmp_path / "ta")]))
    assert os.path.exists(res["best_path"]) and "best acc" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_privacy.run(train_privacy.parser().parse_args(["--device", "cpu"]))
