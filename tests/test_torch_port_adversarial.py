"""Parity of the port's adversarial anonymizer stage with ted_spad_tpu's, on the CPU:
one fa step and one fb/ft step from bridged weights at dropout 0, in float64 ('ce',
'con', quirk_compat, and the fa step under accum_steps=2 against JAX's _fa_step_accum);
activation checkpointing ("on", "blocks", "off" give the same step, the BN
statistics move once, dropout masks replay under recomputation); fb and ft left
without a gradient by the fa step; and the stage driver in both packages
(histories, checkpoints that cross-load, a ragged batch under accum_steps). Tiny
UNet++ fa, tiny ResNet50SSL fb, tiny I3Res50 ft, 32^2, float32 unless a test says
otherwise, torch on one thread; the limits are test_torch_port_train_stages.py's
(stated there)."""

from __future__ import annotations

import copy
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_train_stages import TINY_FT, bridged, check_step, flat, port_grads, rel

from ted_spad_tpu.config.params import AnonymizationParams as JaxAnonymizationParams
from ted_spad_tpu.data import images as jax_images
from ted_spad_tpu.data import videos as jax_videos
from ted_spad_tpu.models import load_fa_model as jax_load_fa
from ted_spad_tpu.models import load_fb_model as jax_load_fb
from ted_spad_tpu.models import load_ft_model as jax_load_ft
from ted_spad_tpu.ops import augment as jax_augment
from ted_spad_tpu.stages import anonymization_training as jax_anon
from ted_spad_tpu.stages.common import make_optimizer as jax_make_optimizer
from ted_spad_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from ted_spad_tpu_torch.config.params import AnonymizationParams
from ted_spad_tpu_torch.data import images
from ted_spad_tpu_torch.data.videos import synthetic_video_items
from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model
from ted_spad_tpu_torch.models.layers import BN_EPS, checkpoint, dropout, flax_batch_norm
from ted_spad_tpu_torch.stages import anonymization_training as anon
from ted_spad_tpu_torch.stages.common import make_optimizer
from ted_spad_tpu_torch.utils.checkpoint import load_checkpoint
from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax

torch.set_num_threads(1)

SIDE, T = 32, 8
N_PAIRS, N_VIDEOS = 8, 4
COMMON = dict(num_classes=5, num_frames=T, reso_h=SIDE, reso_w=SIDE, compute_dtype="float32",
              learning_rate=1e-3, remat="off")


@functools.lru_cache(maxsize=None)
def _inputs(seed: int = 0):
    """Augmented inputs of one step, from JAX's augmentation of seeded images and
    clips: VISPR views (N_PAIRS, 32, 32, 3) with the shared crop origin, clips
    (N_VIDEOS, 3, 8, 32, 32, 3) of different brightness (so the ft's train-mode
    head normalizes well-spread embeddings), labels with a repeated class (SupCon)."""
    rng = np.random.default_rng(seed)
    src = images.SyntheticImageSource(n=N_PAIRS, seed=seed, canonical=40)
    imgs = jnp.asarray(src.get_batch(list(range(N_PAIRS)))[0])[:, None]
    p1 = jax_images.sample_image_augment_params(rng, N_PAIRS, 40, SIDE, SIDE)
    p2 = jax_images.sample_image_augment_params(rng, N_PAIRS, 40, SIDE, SIDE,
                                                shared_crop_origin=(p1.y0.copy(), p1.x0.copy()))
    v1 = np.asarray(jax_augment.augment_batch(imgs, p1.to_device(), SIDE, SIDE)[:, 0])
    v2 = np.asarray(jax_augment.augment_batch(imgs, p2.to_device(), SIDE, SIDE)[:, 0])
    gain = np.array([0.2, 0.5, 0.8, 1.0])[:, None, None, None, None, None]
    raw = (rng.integers(0, 256, (N_VIDEOS, 3, T, 40, 48, 3)) * gain).astype(np.uint8)
    draw = jax_augment.sample_augment_params(rng, N_VIDEOS * 3, 40, 48, SIDE, SIDE)
    clips = np.asarray(jax_augment.augment_batch(jnp.asarray(raw).reshape((-1, T, 40, 48, 3)),
                                                 draw.to_device(), SIDE, SIDE))
    labels = np.array([0, 3, 0, 2], np.int32)
    return v1, v2, clips.reshape((N_VIDEOS, 3) + clips.shape[1:]), labels


def _models(dropout_rate: float = 0.0, dtype: str = "float32", with_jax: bool = True):
    """(port fa, fb, ft with the perturbed weights, their flax trees, JAX modules or
    None), in ``dtype`` (float64 needs ``jax.enable_x64``)."""
    fa, fa_tree = bridged(load_fa_model(tiny=True, dtype="float32", device="cpu"), 11)
    fb, fb_tree = bridged(load_fb_model(ssl=True, tiny=True, dtype="float32", device="cpu"), 12)
    ft_kw = dict(TINY_FT, dropout_rate=dropout_rate)
    ft, ft_tree = bridged(load_ft_model(dtype="float32", device="cpu", **ft_kw), 13)
    for m in (fa, fb, ft):
        m.to(getattr(torch, dtype)).requires_grad_(True)
    trees = tuple(jax.tree_util.tree_map(lambda a: a.astype(dtype), t) for t in (fa_tree, fb_tree, ft_tree))
    if not with_jax:
        return (fa, fb, ft), trees, None
    jmods = (jax_load_fa(image_size=(SIDE, SIDE), dtype=dtype, tiny=True)[0],
             jax_load_fb(ssl=True, tiny=True, image_size=(SIDE, SIDE), dtype=dtype)[0],
             jax_load_ft(clip_shape=(T, SIDE, SIDE), dtype=dtype, **ft_kw)[0])
    return (fa, fb, ft), trees, jmods


def _with_grads(opt: optax.GradientTransformation) -> optax.GradientTransformation:
    """``opt`` whose state also carries the gradient it was last given, so one JAX step
    returns both its update and its gradient."""
    def init(params):
        return opt.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _dev(tree):
    return jax.tree_util.tree_map(jnp.asarray, copy.deepcopy(tree))


def _repeated(step):
    """``step()``'s result, after checking that a second call gives the same bits: JAX's
    adversarial steps repeat exactly on the CPU (tests/test_torch_port_repeat.py holds
    the port's; on the card the port's do not, ROADMAP Queue 3)."""
    first = step()
    again = step()
    a, b = (jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, r)) for r in (first, again))
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    return first


FA_CASES = {
    "ce": dict(),
    "con_quirk": dict(loss="con", quirk_compat=True),
    "accum2": dict(accum_steps=2),
}


@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_fa_step_matches_jax(case):
    """One fa step (fa in train mode over VISPR view 1, view 2 and the clips, BN
    statistics chained; frozen eval fb and ft; -fb_w * NT-Xent + ft_w * (CE or SupCon +
    0.1 triplet); Adam on the fa) against JAX's make_fa_step from bridged weights: the
    loss, every fa gradient, the fa after Adam and its statistics; the four losses;
    fb and ft left without a gradient and their statistics unmoved. accum2: two
    microbatches, gradients and losses averaged, against JAX's _fa_step_accum.
    Held in float64 on both sides: in float32 the fa's gradients through its three
    train-mode forwards (96 clip frames) and the frozen fb's NT-Xent at temperature
    0.1 carry a rounding error of up to 3e-2 of a tensor's norm in JAX (9e-4 in the
    port), measured against float64; in float64 the packages agree to 5e-7."""
    kw = dict(COMMON, **FA_CASES[case])
    p, jp = AnonymizationParams(**kw), JaxAnonymizationParams(**kw)
    v1, v2, clips, labels = _inputs()  # JAX's float32 augmentation, then widened
    v1, v2, clips = (a.astype(np.float64) for a in (v1, v2, clips))
    with jax.enable_x64(True):
        (fa, fb, ft), (fa_tree, fb_tree, ft_tree), (jfa, jfb, jft) = _models(dtype="float64")
        opt = _with_grads(jax_make_optimizer(p.opt_type, p.learning_rate_fa, p.weight_decay))
        jstep = jax_anon.make_fa_step(jfa, jfb, jft, opt, jp, accum_steps=p.accum_steps)

        def jax_step():
            state = _dev(fa_tree)  # donated by the step
            return jstep(state, opt.init(state["params"]), _dev(fb_tree), _dev(ft_tree),
                         jax.random.PRNGKey(0), *map(jnp.asarray, (v1, v2, clips, labels)))

        new, (_, jgrads), *jlosses = _repeated(jax_step)
        new = jax.tree_util.tree_map(np.asarray, new)
    fb_stats, ft_stats = flat(state_dict_to_flax(fb)["batch_stats"]), flat(state_dict_to_flax(ft)["batch_stats"])

    opt_fa = make_optimizer(fa.parameters(), p.opt_type, p.learning_rate_fa, p.weight_decay)
    step = anon.make_fa_step(fa, fb, ft, opt_fa, p, device="cpu")
    losses = step(*(torch.tensor(a) for a in (v1, v2, clips)), labels)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    check_step(fa, losses[0], jlosses[0], flat(jgrads), flat(fa_tree["params"]), new["params"],
               new["batch_stats"], coupled_decay=p.weight_decay)
    assert all(q.grad is None for m in (fb, ft) for q in m.parameters())
    for m, before in ((fb, fb_stats), (ft, ft_stats)):
        after = flat(state_dict_to_flax(m)["batch_stats"])
        assert all(np.array_equal(after[k], before[k]) for k in before)


@pytest.mark.parametrize("case", ["ce", "con_quirk"])
def test_fbft_step_matches_jax(case):
    """One fb/ft step (frozen eval fa; fb in train mode over the two anonymized views,
    BN chained, NT-Xent; ft in train mode over all views, CE or SupCon + 0.1 triplet;
    one backward, each model's own Adam) against JAX's make_fbft_step at dropout 0:
    the losses, every gradient, the parameters after Adam and the statistics of both.
    Held in float64 on both sides, as the fa step: in float32 the two packages' fb/ft
    gradients differ by up to 6e-5 of a tensor's norm (fb's train-mode BN over eight
    images with a 1x1 last stage, the head's over twelve clips), too close to the 1e-4
    limit to tell a fault from rounding."""
    kw = dict(COMMON, loss="con", quirk_compat=True) if case == "con_quirk" else dict(COMMON)
    p, jp = AnonymizationParams(**kw), JaxAnonymizationParams(**kw)
    v1, v2, clips, labels = _inputs(1)  # JAX's float32 augmentation, then widened
    v1, v2, clips = (a.astype(np.float64) for a in (v1, v2, clips))
    with jax.enable_x64(True):
        (fa, fb, ft), (fa_tree, fb_tree, ft_tree), (jfa, jfb, jft) = _models(dtype="float64")
        opt_fb = _with_grads(jax_make_optimizer(p.opt_type, p.learning_rate_fb, p.weight_decay))
        opt_ft = _with_grads(jax_make_optimizer(p.opt_type, p.learning_rate_ft, p.weight_decay))
        jstep = jax_anon.make_fbft_step(jfa, jfb, jft, opt_fb, opt_ft, jp)

        def jax_step():
            fbs, fts = _dev(fb_tree), _dev(ft_tree)  # donated by the step
            return jstep(_dev(fa_tree), fbs, fts, opt_fb.init(fbs["params"]), opt_ft.init(fts["params"]),
                         jax.random.PRNGKey(0), *map(jnp.asarray, (v1, v2, clips, labels)))

        new_fb, new_ft, (_, g_fb), (_, g_ft), *jlosses = _repeated(jax_step)
        new_fb, new_ft = (jax.tree_util.tree_map(np.asarray, t) for t in (new_fb, new_ft))
        g_fb, g_ft, jlosses = (jax.tree_util.tree_map(np.asarray, t) for t in (g_fb, g_ft, jlosses))

    port_fb = make_optimizer(fb.parameters(), p.opt_type, p.learning_rate_fb, p.weight_decay)
    port_ft = make_optimizer(ft.parameters(), p.opt_type, p.learning_rate_ft, p.weight_decay)
    step = anon.make_fbft_step(fa, fb, ft, port_fb, port_ft, p, device="cpu")
    losses = step(*(torch.tensor(a) for a in (v1, v2, clips)), labels)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    for model, loss, jloss, grads, tree, new in ((fb, losses[0], jlosses[0], g_fb, fb_tree, new_fb),
                                                 (ft, losses[1], jlosses[1], g_ft, ft_tree, new_ft)):
        check_step(model, loss, jloss, flat(grads), flat(tree["params"]), new["params"],
                   new["batch_stats"], coupled_decay=p.weight_decay)
    assert all(q.grad is None for q in fa.parameters())


# ---------------------------------------------------------------------------
# Activation checkpointing
# ---------------------------------------------------------------------------


def _port_step(which: str, remat: str, dropout_rate: float = 0.0, loss: str = "ce"):
    """A port step under ``remat``: (losses, gradients, statistics after)."""
    p = AnonymizationParams(**dict(COMMON, remat=remat, loss=loss))
    (fa, fb, ft), _, _ = _models(dropout_rate, with_jax=False)
    v1, v2, clips, labels = (torch.tensor(a) if a.dtype != np.int32 else a for a in _inputs(2))
    if which == "fa":
        step = anon.make_fa_step(fa, fb, ft, make_optimizer(fa.parameters(), "adam", 1e-3), p, device="cpu")
        trained = (fa,)
    else:
        gen = torch.Generator().manual_seed(5)
        step = anon.make_fbft_step(fa, fb, ft, make_optimizer(fb.parameters(), "adam", 1e-3),
                                   make_optimizer(ft.parameters(), "adam", 1e-3), p, generator=gen,
                                   device="cpu")
        trained = (fb, ft)
    losses = step(v1, v2, clips, labels)
    grads = {f"{i}{k}": v for i, m in enumerate(trained) for k, v in port_grads(m).items()}
    stats = {f"{i}{k}": v for i, m in enumerate(trained)
             for k, v in flat(state_dict_to_flax(m)["batch_stats"]).items()}
    return losses.numpy(), grads, stats


@pytest.mark.parametrize("which", ["fa", "fbft"])
def test_remat_gives_the_same_step(which):
    """remat "on" (whole forwards checkpointed) and "blocks" (each fa / ft stage) give
    the step of "off": the same losses and gradients (1e-5 relative), and BN running
    statistics moved once per forward (a second move in the recompute would change
    them by 10% of the batch statistic)."""
    ref = _port_step(which, "off")
    for remat in ("on", "blocks"):
        losses, grads, stats = _port_step(which, remat)
        np.testing.assert_allclose(losses, ref[0], rtol=1e-6)
        assert grads.keys() == ref[1].keys() and stats.keys() == ref[2].keys()
        for k in ref[1]:
            assert rel(grads[k], ref[1][k]) <= 1e-5, (remat, k)
        for k in ref[2]:
            assert rel(stats[k], ref[2][k]) <= 1e-6, (remat, k)


def test_remat_replays_dropout_masks():
    """The fb/ft step at dropout 0.5 from one seeded generator: remat "on" and "off"
    draw the same masks (the recompute replays the generator's state), so the losses
    and every gradient agree; a recompute with fresh masks would not. The helper
    alone: a checkpointed dropout's gradient equals the plain one's, the generator ends
    where one forward leaves it, and the running statistics move once."""
    off = _port_step("fbft", "off", dropout_rate=0.5)
    on = _port_step("fbft", "on", dropout_rate=0.5)
    np.testing.assert_allclose(on[0], off[0], rtol=1e-6)
    for k in off[1]:
        assert rel(on[1][k], off[1][k]) <= 1e-5, k

    x = torch.randn(6, 4, 3, 3, requires_grad=True)
    bn = torch.nn.BatchNorm2d(4, eps=BN_EPS)
    fn = lambda t, g: dropout(flax_batch_norm(bn, t), 0.5, g).square().sum()  # noqa: E731
    grads, ends, stats = [], [], []
    for use in (False, True):
        bn.reset_running_stats()
        g = torch.Generator().manual_seed(3)
        out = checkpoint(fn, x, g, generators=(g,)) if use else fn(x, g)
        grads.append(torch.autograd.grad(out, x)[0])
        ends.append(g.get_state())
        stats.append(bn.running_mean.clone())
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)
    assert torch.equal(ends[0], ends[1]) and torch.equal(stats[0], stats[1])


# ---------------------------------------------------------------------------
# The stage driver
# ---------------------------------------------------------------------------


def _tiny_loaders(monkeypatch):
    for mod, fa_, fb_, ft_ in ((jax_anon, jax_load_fa, jax_load_fb, jax_load_ft),
                               (anon, load_fa_model, load_fb_model, load_ft_model)):
        monkeypatch.setattr(mod, "load_fa_model", functools.partial(fa_, tiny=True))
        monkeypatch.setattr(mod, "load_fb_model", functools.partial(fb_, tiny=True))
        monkeypatch.setattr(mod, "load_ft_model", functools.partial(ft_, tiny=True))


def test_driver_matches_jax_and_cross_loads(tmp_path, monkeypatch):
    """One synthetic epoch of train_anonymizer in each package (the CLI's sizes, 3
    videos per batch under accum_steps=2, so every fa step trims a ragged batch to 2):
    the same history lengths, finite losses, the best checkpoint (threshold -1)
    holding the three models, each loading bit-exactly in the other package's
    load_fa_model / load_fb_model / load_ft_model, the rolling temp and the preview
    PNG; and one epoch with another ft family (full-width R3D-18, which the driver once
    refused) on six of the videos, its losses finite and its checkpoint's ft an R3D-18."""
    _tiny_loaders(monkeypatch)
    kw = dict(num_classes=4, num_frames=8, reso_h=SIDE, reso_w=SIDE, batch_size=3,
              batch_size_vispr=4, v_batch_size=2, num_modes=1, compute_dtype="float32",
              save_acc_threshold=-1.0, accum_steps=2, run_id="adv")
    train = synthetic_video_items(12, 4, num_frames=48, h=40, w=48, seed=0)
    val = synthetic_video_items(2, 4, num_frames=48, h=40, w=48, seed=1)
    vispr = images.SyntheticImageSource(n=16, canonical=48)
    quiet = dict(log_fn=lambda s: None, max_epochs=1, vispr_source=vispr)
    ours = anon.train_anonymizer(AnonymizationParams(**kw), train_items=train, val_items=val,
                                 save_dir=str(tmp_path / "p"), device="cpu", **quiet)
    jitems = [[jax_videos.VideoItem(i.uri, i.label) for i in items] for items in (train, val)]
    ref = jax_anon.train_anonymizer(JaxAnonymizationParams(**kw), train_items=jitems[0],
                                    val_items=jitems[1], save_dir=str(tmp_path / "j"), **quiet)
    lengths = {k: len(v) for k, v in ours["history"].items()}
    assert lengths == {k: len(v) for k, v in ref["history"].items()} == dict.fromkeys(lengths, 1)
    assert np.isfinite([v[0] for v in ours["history"].values()]).all()
    assert (tmp_path / "p" / "adv" / "visuals" / "epoch_1.png").exists()
    assert load_checkpoint(str(tmp_path / "p" / "adv" / "model_temp.ckpt"))["epoch"] == 2
    loaders = {"fa": (load_fa_model, functools.partial(jax_load_fa, image_size=(SIDE, SIDE))),
               "fb": (functools.partial(load_fb_model, ssl=True),
                      functools.partial(jax_load_fb, ssl=True, image_size=(SIDE, SIDE))),
               "ft": (functools.partial(load_ft_model, num_classes=4),
                      functools.partial(jax_load_ft, "largei3d", num_classes=4, clip_shape=(T, SIDE, SIDE)))}
    for path in (ours["best_path"], ref["best_path"]):
        written = jax_load_checkpoint(path)
        for name, (port_loader, jax_loader) in loaders.items():
            port_model = port_loader(saved_model_file=path, tiny=True, dtype="float32", device="cpu")
            _, jvars = jax_loader(saved_model_file=path, tiny=True, dtype="float32")
            a, b = flat(state_dict_to_flax(port_model)), flat(jax.tree_util.tree_map(np.asarray, jvars))
            assert a.keys() == b.keys() == flat(written[f"{name}_model_state_dict"]).keys(), name
            assert all(np.array_equal(a[k], b[k]) for k in a), name
    monkeypatch.setattr(anon, "load_ft_model", load_ft_model)  # r3d_18 has no tiny form
    other = anon.train_anonymizer(AnonymizationParams(**dict(kw, arch_ft="r3d_18")), train_items=train[:6],
                                  val_items=val, save_dir=str(tmp_path / "x"), device="cpu", **quiet)
    assert np.isfinite([v[0] for v in other["history"].values()]).all()
    assert type(other["ft"]).__name__ == "R3D18"
    load_ft_model("r3d_18", saved_model_file=other["best_path"], num_classes=4, clip_shape=(T, SIDE, SIDE),
                  dtype="float32", device="cpu")
