"""Parity of the port's training stages with ted_spad_tpu's, from bridged weights: one
whole train step of fa pretraining (UNet++ and UNet) and of action training (ce, con,
trip, anonymized, quirk_compat) at dropout 0, and both stage drivers (histories,
checkpoints that load in the other package, the trained models serving through the
extraction stage, restart, eval_only, a failing epoch). float32 unless a test says
otherwise, torch on one thread. The helpers here serve test_torch_port_training_ops.py
too."""

from __future__ import annotations

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ted_spad_tpu.config.params import ActionParams as JaxActionParams
from ted_spad_tpu.config.params import FeatureExtractionParams as JaxFeatureExtractionParams
from ted_spad_tpu.config.params import ReconstructionParams as JaxReconstructionParams
from ted_spad_tpu.data import images as jax_images
from ted_spad_tpu.data import videos as jax_videos
from ted_spad_tpu.models import load_fa_model as jax_load_fa
from ted_spad_tpu.models import load_ft_model as jax_load_ft
from ted_spad_tpu.ops import augment as jax_augment
from ted_spad_tpu.ops import losses as jax_losses
from ted_spad_tpu.stages import action_training as jax_action
from ted_spad_tpu.stages import fa_pretraining as jax_fa
from ted_spad_tpu.stages import feature_extraction as jax_fe
from ted_spad_tpu.stages.common import make_optimizer as jax_make_optimizer
from ted_spad_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from ted_spad_tpu_torch.config.params import ActionParams, FeatureExtractionParams, ReconstructionParams
from ted_spad_tpu_torch.data.images import ReconstructionSource
from ted_spad_tpu_torch.data.videos import synthetic_video_items
from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
from ted_spad_tpu_torch.ops.augment import AugmentParams
from ted_spad_tpu_torch.stages import action_training, fa_pretraining
from ted_spad_tpu_torch.stages import feature_extraction as fe
from ted_spad_tpu_torch.stages.common import make_optimizer
from ted_spad_tpu_torch.utils.checkpoint import load_checkpoint
from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables, state_dict_to_flax

torch.set_num_threads(1)

OUT_RTOL = 1e-4     # train-mode outputs, ||d|| / ||ref||
STATS_RTOL = 1e-5   # running statistics after a train-mode forward or a step
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4    # ||d grad|| / ||grad|| per tensor
PARAM_RTOL = 1e-3   # ||d theta|| / ||theta_t - theta_0|| per tensor after Adam
# A gradient that is zero in exact arithmetic (a bias ahead of a train-mode BatchNorm,
# which removes it) is rounding noise in both packages: held absolutely, below this
# share of the largest gradient, and left out of the Adam comparison, whose first
# step divides that noise by its own size. For the same reason the Adam comparison
# leaves out the entries whose gradient (with Adam's coupled L2 term, g + wd * theta)
# is below ADAM_FLOOR of the tensor's RMS gradient, about 1% of them: Adam's first
# step moves an entry by lr * g / (|g| + eps), about lr times the sign of g, and for
# those entries that sign is a difference of rounding-sized numbers.
NULL_GRAD = 1e-5
ADAM_FLOOR = 1e-2
TINY_FT = dict(tiny=True, num_classes=5, dropout_rate=0.0)
CLIP = (8, 32, 32)


def perturbed(tree, seed: int):
    """numpy copy of a flax variables tree with every leaf moved off its init."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x * rng.uniform(0.8, 1.2, x.shape) + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, tree))


def flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def port_grads(model) -> dict:
    g = copy.deepcopy(model)
    for (_, dst), (_, src) in zip(g.named_parameters(), model.named_parameters()):
        dst.data = src.grad.detach().clone()
    return flat(state_dict_to_flax(g)["params"])


def bridged(port_model, seed: int):
    """(port model with the perturbed weights, the same weights as a flax tree)."""
    tree = perturbed(state_dict_to_flax(port_model), seed)
    return load_jax_variables(port_model, tree), tree


def as_port_draw(draw) -> AugmentParams:
    return AugmentParams(**{k: getattr(draw, k) for k in AugmentParams.__dataclass_fields__})


def check_step(model, loss, jloss, jgrads, theta0, jparams, jstats, coupled_decay: float = 0.0) -> None:
    """Loss, gradients, parameters after the optimizer and BN statistics of one port
    step against JAX's (module docstring for the limits); ``coupled_decay``: the L2
    weight Adam adds to the gradient."""
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), (loss, jloss)
    grads = port_grads(model)
    assert grads.keys() == jgrads.keys()
    top = max(np.linalg.norm(g) for g in jgrads.values())
    null = {k for k, g in jgrads.items() if np.linalg.norm(g) <= NULL_GRAD * top}
    for k in jgrads:
        if k in null:
            assert np.linalg.norm(grads[k]) <= NULL_GRAD * top, k
        else:
            assert rel(grads[k], jgrads[k]) <= GRAD_RTOL, (k, rel(grads[k], jgrads[k]))
    ours = state_dict_to_flax(model)
    got, want = flat(ours["params"]), flat(jparams)
    for k in want:
        if k in null:
            continue
        live = np.abs(jgrads[k] + coupled_decay * theta0[k]) > ADAM_FLOOR * np.sqrt(np.mean(jgrads[k] ** 2))
        update = np.linalg.norm((want[k] - theta0[k])[live])
        assert update > 0 and np.linalg.norm((got[k] - want[k])[live]) <= PARAM_RTOL * update, k
    got_stats, want_stats = flat(ours.get("batch_stats", {})), flat(jstats)
    assert got_stats.keys() == want_stats.keys()
    for k in want_stats:
        assert rel(got_stats[k], want_stats[k]) <= STATS_RTOL, k


# ---------------------------------------------------------------------------
# Whole train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["unet++", "unet"])
def test_fa_train_step_matches_jax(arch, monkeypatch):
    """One fa pretraining step (augment -> fa in train mode -> L1 -> Adam) from bridged
    weights, on the same images and draw: loss, gradients, parameters, statistics.
    The full-width UNet's step is held in float64 on both sides: in float32 its
    gradients through nine train-mode DoubleConvs carry a rounding error of up to
    5e-3 of a tensor's norm in JAX (3e-4 in the port), measured against float64. JAX
    augments in float32 for any model, so the port's float64 step is given a float32
    augmentation too (its own default for a float64 model is float64): float32
    rounding of the input alone moves this step's gradients by 4e-4."""
    monkeypatch.setattr(fa_pretraining, "augment_dtype", lambda model: torch.float32)
    kw = dict(tiny=True) if arch == "unet++" else {}
    dtype = "float32" if arch == "unet++" else "float64"
    with jax.enable_x64(dtype == "float64"):
        port = load_fa_model(arch, dtype="float32", device="cpu", **kw)
        port, tree = bridged(port, 3)
        port = port.to(getattr(torch, dtype)).requires_grad_(True)
        tree = jax.tree_util.tree_map(lambda x: x.astype(dtype), tree)
        jmodel = jax_load_fa(arch=arch, image_size=(32, 32), dtype=dtype, **kw)[0]
        images = ReconstructionSource(synthetic_n=4, seed=1, canonical=40).get_batch([0, 1, 2, 3])[0]
        draw = jax_images.sample_image_augment_params(np.random.default_rng(4), 4, 40, 32, 32)
        draw.do_hue[:2] = True  # exercise the colour path on half the batch

        def loss_fn(params):
            aug = jax_augment.augment_batch(jnp.asarray(images)[:, None], draw.to_device(), 32, 32)[:, 0]
            recon, _ = jmodel.apply({**tree, "params": params}, aug, train=True, mutable=["batch_stats"])
            return jax_losses.l1_loss(recon, aug)

        jgrads = flat(jax.jit(jax.grad(loss_fn))(tree["params"]))
        optimizer = jax_make_optimizer("adam", 1e-3)
        jstep = jax_fa.make_train_step(jmodel, optimizer, (32, 32))
        state = jax.tree_util.tree_map(jnp.asarray, tree)
        new, _, jloss = jstep(state, optimizer.init(state["params"]), jnp.asarray(images),
                              draw.to_device())
        new = jax.tree_util.tree_map(np.asarray, new)

    step = fa_pretraining.make_train_step(port, make_optimizer(port.parameters(), "adam", 1e-3), (32, 32),
                                          compute_dtype="float32", device="cpu")
    loss = step(images, as_port_draw(draw))
    check_step(port, loss, jloss, jgrads, flat(tree["params"]), new["params"], new["batch_stats"])


FT_CASES = {  # every loss, temporal loss, optimizer and fa variant, each at least once
    "ce": dict(),
    "con_con": dict(loss="con", temporal_loss="con", opt_type="sgd"),
    "anonymized_trip": dict(temporal_loss="trip", anonymized=True, opt_type="adamw"),
    "quirk_trip": dict(temporal_loss="trip", anonymized=True, quirk_compat=True),
}


@pytest.mark.parametrize("case", sorted(FT_CASES))
def test_ft_train_step_matches_jax(case):
    """One action training step (augment -> [frozen fa] -> one batched ft forward over
    every view, FrozenBN backbone, train-mode MLP head -> loss -> optimizer) from
    bridged weights at dropout 0, on the same clips, labels and draw."""
    extra = FT_CASES[case]
    common = dict(num_classes=5, num_frames=8, reso_h=32, reso_w=32, compute_dtype="float32",
                  learning_rate=1e-3, weight_decay=1e-2, **extra)
    p, jp = ActionParams(**common), JaxActionParams(**common)
    ft, tree = bridged(load_ft_model(dtype="float32", device="cpu", **TINY_FT).requires_grad_(True), 5)
    jft = jax_load_ft(clip_shape=CLIP, dtype="float32", **TINY_FT)[0]
    fa = jfa = None
    if p.anonymized:
        fa, fa_tree = bridged(load_fa_model(tiny=True, dtype="float32", device="cpu"), 6)
        jfa = (jax_load_fa(image_size=(32, 32), dtype="float32", tiny=True)[0],
               jax.tree_util.tree_map(jnp.asarray, fa_tree))
    v = action_training.views_for(p)
    rng = np.random.default_rng(7)
    b = 3
    # Videos of different brightness, so the MLP head's batch statistics are well
    # conditioned over the batch's few embeddings.
    gain = np.array([0.2, 0.6, 1.0])[:, None, None, None, None, None]
    clips = (rng.integers(0, 256, (b, v, 8, 40, 48, 3)) * gain).astype(np.uint8)
    labels = np.array([0, 3, 0], np.int32)
    draw = jax_augment.sample_augment_params(rng, b * v, 40, 48, 32, 32)
    draw.do_hflip[:] = [True, False] * (b * v // 2) + [True] * (b * v % 2)

    def loss_fn(params):
        x = jax_augment.augment_batch(jnp.asarray(clips).reshape((b * v,) + clips.shape[2:]),
                                      draw.to_device(), 32, 32)
        if jfa is not None:
            if p.quirk_compat:
                tv = jax_action._apply_fa_frames(*jfa, x.reshape((b, v * 8) + x.shape[2:]), quirk=True)
                x = tv.reshape(x.shape)
            else:
                x = jax_action._apply_fa_frames(*jfa, x)
        (logits, emb), _ = jft.apply({**tree, "params": params}, x, train=True, frozen_bn=True,
                                     mutable=["batch_stats"])
        logits, emb = logits.reshape(b, v, -1)[:, 0], emb.reshape(b, v, -1)
        if v > 1 and p.loss == "con":
            loss = jax_losses.supcon_loss(jax_losses.l2_normalize(emb[:, :2], axis=-1), labels)
        else:
            loss = jax_losses.cross_entropy_loss(logits, labels)
        if p.temporal_loss == "trip":
            loss += p.temporal_loss_weight * jax_losses.triplet_margin_loss(emb[:, 0], emb[:, 1], emb[:, 2])
        elif p.temporal_loss == "con":
            loss += p.temporal_loss_weight * jax_losses.nt_xent_loss(emb[:, 0], emb[:, 1])
        return loss

    jgrads = flat(jax.jit(jax.grad(loss_fn))(tree["params"]))
    optimizer = jax_make_optimizer(p.opt_type, p.learning_rate, p.weight_decay, p.momentum)
    state = jax.tree_util.tree_map(jnp.asarray, tree)
    jstep = jax_action.make_train_step(jft, optimizer, jp, jfa)
    new, _, jloss = jstep(state, optimizer.init(state["params"]), jax.random.PRNGKey(0),
                          jnp.asarray(clips), jnp.asarray(labels), draw.to_device())

    opt = make_optimizer(ft.parameters(), p.opt_type, p.learning_rate, p.weight_decay, p.momentum)
    step = action_training.make_train_step(ft, opt, p, fa, device="cpu")
    loss = step(clips, labels, as_port_draw(draw))
    check_step(ft, loss, jloss, jgrads, flat(tree["params"]), new["params"], new["batch_stats"],
               coupled_decay=p.weight_decay if p.opt_type == "adam" else 0.0)


# ---------------------------------------------------------------------------
# Stage drivers and CLIs
# ---------------------------------------------------------------------------


def _tiny_loaders(monkeypatch):
    """Both packages' stage drivers build tiny fa / ft models (dropout 0 for the ft)."""
    monkeypatch.setattr(jax_fa, "load_fa_model", functools.partial(jax_load_fa, tiny=True))
    monkeypatch.setattr(jax_action, "load_fa_model", functools.partial(jax_load_fa, tiny=True))
    monkeypatch.setattr(jax_action, "load_ft_model", functools.partial(jax_load_ft, tiny=True))
    monkeypatch.setattr(fa_pretraining, "load_fa_model", functools.partial(load_fa_model, tiny=True))
    monkeypatch.setattr(action_training, "load_fa_model", functools.partial(load_fa_model, tiny=True))
    monkeypatch.setattr(action_training, "load_ft_model", functools.partial(load_ft_model, tiny=True))


def _same_tree(a, b) -> None:
    fa_, fb = flat(a), flat(b)
    assert fa_.keys() == fb.keys()
    for k in fa_:
        np.testing.assert_array_equal(fa_[k], fb[k], err_msg=k)


def test_stage_drivers_match_jax_and_cross_load(tmp_path, monkeypatch):
    """A 1-epoch synthetic run of train_reconstruction and of anonymized train_action
    ('trip') in each package: the same history lengths; every checkpoint either
    package wrote loads bit-exactly in the other's load_fa_model / load_ft_model; the
    port's trained fa and ft serve through the port's extraction stage as they do
    through JAX's; restart, eval_only and the refusal of other ft families."""
    _tiny_loaders(monkeypatch)
    quiet = dict(log_fn=lambda s: None)
    rp = dict(run_id="fa", batch_size=4, reso_h=32, reso_w=32, compute_dtype="float32", warmup=2)
    src = dict(train_source=ReconstructionSource(synthetic_n=8, canonical=40),
               val_source=ReconstructionSource(synthetic_n=4, seed=1, canonical=40), max_epochs=1)
    ours = fa_pretraining.train_reconstruction(ReconstructionParams(**rp), save_dir=str(tmp_path / "p"),
                                               device="cpu", **src, **quiet)
    ref = jax_fa.train_reconstruction(JaxReconstructionParams(**rp), save_dir=str(tmp_path / "j"),
                                      **src, **quiet)
    assert {k: len(v) for k, v in ours["history"].items()} == {k: len(v) for k, v in ref["history"].items()} \
        == {"train_loss": 1, "val_loss": 1}
    assert np.isfinite(ours["history"]["train_loss"]).all()
    fa_ckpts = {"p": ours["best_path"], "j": ref["best_path"]}
    temp = load_checkpoint(str(tmp_path / "p" / "fa" / "model_temp.ckpt"))
    assert temp["epoch"] == 2 and "lr_counter" in temp
    for who, path in fa_ckpts.items():
        port_fa = load_fa_model(saved_model_file=path, dtype="float32", device="cpu", tiny=True)
        _, jvars = jax_load_fa(path, image_size=(32, 32), dtype="float32", tiny=True)
        _same_tree(state_dict_to_flax(port_fa), jvars)
        _same_tree(jvars, jax_load_checkpoint(path)["fa_model_state_dict"])

    ap = dict(run_id="act", num_classes=4, num_frames=8, reso_h=32, reso_w=32, batch_size=4,
              v_batch_size=4, num_modes=2, temporal_loss="trip", compute_dtype="float32",
              anonymized=True, saved_model_fa=fa_ckpts["p"])
    items = dict(train_items=synthetic_video_items(8, 4, num_frames=40, h=40, w=48, seed=0),
                 val_items=synthetic_video_items(4, 4, num_frames=40, h=40, w=48, seed=1),
                 max_epochs=1)
    ours = action_training.train_action(ActionParams(**ap), save_dir=str(tmp_path / "p"), device="cpu",
                                        **items, **quiet)
    jitems = dict(items, train_items=[jax_videos.VideoItem(i.uri, i.label) for i in items["train_items"]],
                  val_items=[jax_videos.VideoItem(i.uri, i.label) for i in items["val_items"]])
    ref = jax_action.train_action(JaxActionParams(**ap), save_dir=str(tmp_path / "j"), **jitems, **quiet)
    assert {k: len(v) for k, v in ours["history"].items()} == {k: len(v) for k, v in ref["history"].items()} \
        == {"train_loss": 1, "val_acc": 1}
    assert np.isfinite(ours["history"]["train_loss"]).all() and 0 <= ours["best_acc"] <= 1
    ft_ckpts = {"p": ours["best_path"], "j": ref["best_path"]}
    for who, path in ft_ckpts.items():
        port_ft = load_ft_model(saved_model_file=path, dtype="float32", device="cpu", tiny=True)
        assert port_ft.i3d.fc.out_features == 4  # the width comes from the file
        _, jvars = jax_load_ft("largei3d", path, num_classes=4, clip_shape=CLIP, dtype="float32", tiny=True)
        _same_tree(state_dict_to_flax(port_ft), jvars)

    # The port's trained fa and ft through the extraction stage of each package.
    fa = load_fa_model(saved_model_file=fa_ckpts["p"], dtype="float32", device="cpu", tiny=True)
    ft = load_ft_model(saved_model_file=ft_ckpts["p"], dtype="float32", device="cpu", tiny=True)
    jfa = jax_load_fa(fa_ckpts["p"], image_size=(32, 32), dtype="float32", tiny=True)
    jft = jax_load_ft("largei3d", ft_ckpts["p"], num_classes=4, clip_shape=CLIP, dtype="float32", tiny=True)
    monkeypatch.setattr(jax_fe, "load_fa_model", lambda *a, **k: jfa)
    monkeypatch.setattr(jax_fe, "load_ft_model", lambda *a, **k: jft)
    uris = [f"synthetic://n=40,h=40,w=48,seed={s}" for s in (0, 1001)]
    common = dict(num_frames=8, fix_skip=2, batch_size=2, reso_h=32, reso_w=32, compute_dtype="float32")
    got = fe.extract_features(FeatureExtractionParams(**common), uris, str(tmp_path / "fp"), fa=fa, ft=ft,
                              decode_hw=(40, 48), num_workers=2, device="cpu", **quiet)
    want = jax_fe.extract_features(JaxFeatureExtractionParams(**common), uris, str(tmp_path / "fj"),
                                   decode_hw=(40, 48), num_workers=2, **quiet)
    for uri, path in got["saved"].items():
        a, b = np.load(path), np.load(want["saved"][uri])
        assert a.shape == b.shape and a.shape[1] == 256 and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)

    # restart resumes after the temp's epoch; eval_only evaluates the given weights.
    logs = []
    again = action_training.train_action(ActionParams(**ap, restart=True), save_dir=str(tmp_path / "p"),
                                         device="cpu", log_fn=logs.append, **dict(items, max_epochs=2))
    assert any("restarted" in m and "epoch 2" in m for m in logs) and len(again["history"]["train_loss"]) == 1
    only = action_training.train_action(ActionParams(**ap, eval_only=True, saved_model=ft_ckpts["p"]),
                                        save_dir=str(tmp_path / "e"), device="cpu", **items, **quiet)
    assert only["history"]["val_acc"] == [only["best_acc"]] == [ours["best_acc"]]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        action_training.train_action(ActionParams(**ap, arch="i3d"), save_dir=str(tmp_path / "x"),
                                     device="cpu", **items, **quiet)


def test_reconstruction_survives_a_bad_epoch(tmp_path, monkeypatch):
    """A failing batch load kills one epoch, which is logged with its traceback; the
    run goes on (train_reconstruction.py:149-203)."""
    _tiny_loaders(monkeypatch)
    base = ReconstructionSource(synthetic_n=8, canonical=40)
    calls = []

    class Flaky:
        def __len__(self):
            return len(base)

        def get_batch(self, idx):
            calls.append(1)
            if len(calls) == 2:  # the first training batch of epoch 1
                raise IOError("corrupt image")
            return base.get_batch(idx)

    logs = []
    p = ReconstructionParams(run_id="flaky", batch_size=4, reso_h=32, reso_w=32, compute_dtype="float32")
    res = fa_pretraining.train_reconstruction(p, train_source=Flaky(), save_dir=str(tmp_path),
                                              max_epochs=2, log_fn=logs.append, device="cpu")
    assert any("epoch 1 failed; continuing" in m and "corrupt image" in m for m in logs)
    assert len(res["history"]["train_loss"]) == 1 and np.isfinite(res["history"]["train_loss"]).all()
