"""Parity of the port's adversarial anonymizer steps with the ft families beside
I3Res50 -- InceptionI3d, R3D-18 and MViTv2-S at full width -- with ted_spad_tpu's, on the
CPU: the fa step with the frozen i3d ft and the fb/ft step with r3d_18 and with mvitv2,
from bridged weights at dropout 0 in float64 (the limits of
test_torch_port_train_stages.py, as test_torch_port_adversarial.py holds the largei3d
steps); activation checkpointing ("on", "blocks", "off" give the same step with R3D-18,
whose forward "blocks" checkpoints whole, as JAX's block policy names none of its
values); and InceptionI3d's dropout masks replayed by a checkpointed forward. Tiny UNet++
fa and ResNet50SSL fb, 4 VISPR pairs; i3d at 9x208x208 (its smallest clip the UNet++ fa
takes in JAX, whose decoder needs sides that 16 divides), one video; r3d_18 and mvitv2
at 4x16x16, two videos. Torch on one thread."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_adversarial import _dev, _with_grads
from test_torch_port_ft_train import N_CLASSES, _clip_batch, _ft
from test_torch_port_train_stages import bridged, check_step, flat, port_grads, rel

from ted_spad_tpu.config.params import AnonymizationParams as JaxAnonymizationParams
from ted_spad_tpu.data import images as jax_images
from ted_spad_tpu.models import load_fa_model as jax_load_fa
from ted_spad_tpu.models import load_fb_model as jax_load_fb
from ted_spad_tpu.ops import augment as jax_augment
from ted_spad_tpu.stages import anonymization_training as jax_anon
from ted_spad_tpu.stages.common import make_optimizer as jax_make_optimizer
from ted_spad_tpu_torch.cli import I3D_SMALLEST_CLIP
from ted_spad_tpu_torch.config.params import AnonymizationParams
from ted_spad_tpu_torch.data import images
from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model
from ted_spad_tpu_torch.stages import anonymization_training as anon
from ted_spad_tpu_torch.stages.common import make_optimizer
from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax

torch.set_num_threads(1)

ADV_CASES = {"i3d": "fa", "r3d_18": "fbft", "mvitv2": "fbft"}
ADV_CLIPS = {"i3d": (1, (9, 208, 208)), "r3d_18": (2, (4, 16, 16)), "mvitv2": (2, (4, 16, 16))}
N_PAIRS = 4


@functools.lru_cache(maxsize=None)
def _adv_inputs(arch: str, seed: int = 0):
    """Augmented inputs of one adversarial step at the family's clip, from JAX's
    augmentation: VISPR views (N_PAIRS, H, W, 3), clips (b, 3, T, H, W, 3), labels."""
    b, clip = ADV_CLIPS[arch]
    t, h, w = clip
    rng = np.random.default_rng(seed)
    src = images.SyntheticImageSource(n=N_PAIRS, seed=seed, canonical=h + 8)
    imgs = jnp.asarray(src.get_batch(list(range(N_PAIRS)))[0])[:, None]
    p1 = jax_images.sample_image_augment_params(rng, N_PAIRS, h + 8, h, w)
    p2 = jax_images.sample_image_augment_params(rng, N_PAIRS, h + 8, h, w,
                                                shared_crop_origin=(p1.y0.copy(), p1.x0.copy()))
    v1 = np.asarray(jax_augment.augment_batch(imgs, p1.to_device(), h, w)[:, 0])
    v2 = np.asarray(jax_augment.augment_batch(imgs, p2.to_device(), h, w)[:, 0])
    raw, labels, draw = _clip_batch(b, clip, seed + 1)
    clips = np.asarray(jax_augment.augment_batch(jnp.asarray(raw).reshape((-1,) + raw.shape[2:]),
                                                 draw.to_device(), h, w))
    return v1, v2, clips.reshape((b, 3) + clips.shape[1:]), labels


def _adv_models(arch: str, dtype: str, dropout_rate: float = 0.0, with_jax: bool = True):
    """Tiny UNet++ fa and ResNet50SSL fb, the full-width ``arch`` ft: (port models,
    flax trees, JAX modules or None) in ``dtype``."""
    _, clip = ADV_CLIPS[arch]
    fa, fa_tree = bridged(load_fa_model(tiny=True, dtype="float32", device="cpu"), 31)
    fb, fb_tree = bridged(load_fb_model(ssl=True, tiny=True, dtype="float32", device="cpu"), 32)
    for m in (fa, fb):
        m.to(getattr(torch, dtype)).requires_grad_(True)
    trees = [jax.tree_util.tree_map(lambda a: a.astype(dtype), t) for t in (fa_tree, fb_tree)]
    ft, ft_tree, jft = _ft(arch, clip, dtype, dropout_rate, seed=33)
    if not with_jax:
        return (fa, fb, ft), (*trees, ft_tree), None
    jmods = (jax_load_fa(image_size=clip[1:], dtype=dtype, tiny=True)[0],
             jax_load_fb(ssl=True, tiny=True, image_size=clip[1:], dtype=dtype)[0], jft)
    return (fa, fb, ft), (*trees, ft_tree), jmods


def _adv_params(arch: str, **extra):
    _, (t, h, w) = ADV_CLIPS[arch]
    kw = dict(dict(arch_ft=arch, num_classes=N_CLASSES, num_frames=t, reso_h=h, reso_w=w,
                   compute_dtype="float32", learning_rate=1e-3, remat="off"), **extra)
    return AnonymizationParams(**kw), JaxAnonymizationParams(**kw)


@pytest.mark.parametrize("arch", sorted(ADV_CASES))
def test_adversarial_step_matches_jax(arch):
    """The adversarial step ADV_CASES gives the family against JAX's, from bridged
    weights at dropout 0, in float64: the fa step (train-mode fa over both VISPR views
    and the clips, frozen fb and eval-mode ft; the loss, every fa gradient, the fa after
    Adam and its statistics; fb and ft left without a gradient) or the fb/ft step
    (frozen fa; train-mode fb and ft, the ft's triplet loss on its own feature; losses,
    gradients, parameters and statistics of both)."""
    p, jp = _adv_params(arch)
    v1, v2, clips, labels = (a.astype(np.float64) if a.dtype != np.int32 else a
                             for a in _adv_inputs(arch))
    with jax.enable_x64(True):
        (fa, fb, ft), (fa_tree, fb_tree, ft_tree), (jfa, jfb, jft) = _adv_models(arch, "float64")
        inputs = tuple(map(jnp.asarray, (v1, v2, clips, labels)))
        if ADV_CASES[arch] == "fa":
            opt = _with_grads(jax_make_optimizer(p.opt_type, p.learning_rate_fa, p.weight_decay))
            state = _dev(fa_tree)
            new, (_, jgrads), *jlosses = jax_anon.make_fa_step(jfa, jfb, jft, opt, jp)(
                state, opt.init(state["params"]), _dev(fb_tree), _dev(ft_tree),
                jax.random.PRNGKey(0), *inputs)
            new = jax.tree_util.tree_map(np.asarray, new)
            jgrads = flat(jgrads)
        else:
            opt_fb = _with_grads(jax_make_optimizer(p.opt_type, p.learning_rate_fb, p.weight_decay))
            opt_ft = _with_grads(jax_make_optimizer(p.opt_type, p.learning_rate_ft, p.weight_decay))
            fbs, fts = _dev(fb_tree), _dev(ft_tree)
            new_fb, new_ft, (_, g_fb), (_, g_ft), *jlosses = jax_anon.make_fbft_step(
                jfa, jfb, jft, opt_fb, opt_ft, jp)(
                _dev(fa_tree), fbs, fts, opt_fb.init(fbs["params"]), opt_ft.init(fts["params"]),
                jax.random.PRNGKey(0), *inputs)
            new_fb, new_ft, g_fb, g_ft = (jax.tree_util.tree_map(np.asarray, t)
                                          for t in (new_fb, new_ft, g_fb, g_ft))
        jlosses = np.asarray(jlosses)

    v1, v2, clips = (torch.tensor(a) for a in (v1, v2, clips))
    if ADV_CASES[arch] == "fa":
        before = flat(state_dict_to_flax(fb).get("batch_stats", {}))
        step = anon.make_fa_step(fa, fb, ft, make_optimizer(fa.parameters(), p.opt_type,
                                                            p.learning_rate_fa, p.weight_decay), p,
                                 device="cpu")
        losses = step(v1, v2, clips, labels)
        np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5)
        check_step(fa, losses[0], jlosses[0], jgrads, flat(fa_tree["params"]), new["params"],
                   new["batch_stats"], coupled_decay=p.weight_decay)
        assert all(q.grad is None for m in (fb, ft) for q in m.parameters())
        after = flat(state_dict_to_flax(fb)["batch_stats"])
        assert all(np.array_equal(after[k], before[k]) for k in before)
    else:
        opts = [make_optimizer(m.parameters(), p.opt_type, lr, p.weight_decay)
                for m, lr in ((fb, p.learning_rate_fb), (ft, p.learning_rate_ft))]
        losses = anon.make_fbft_step(fa, fb, ft, *opts, p, device="cpu")(v1, v2, clips, labels)
        np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5)
        for model, loss, jloss, grads, tree, new in (
                (fb, losses[0], jlosses[0], g_fb, fb_tree, new_fb),
                (ft, losses[1], jlosses[1], g_ft, ft_tree, new_ft)):
            check_step(model, loss, jloss, flat(grads), flat(tree["params"]), new["params"],
                       new.get("batch_stats", {}), coupled_decay=p.weight_decay)
        assert all(q.grad is None for q in fa.parameters())


def _port_adv_step(arch: str, which: str, remat: str, dropout_rate: float = 0.0):
    """A port step of the family under ``remat`` in float64: (losses, gradients,
    statistics after) of the models it trains."""
    p, _ = _adv_params(arch, remat=remat)
    (fa, fb, ft), _, _ = _adv_models(arch, "float64", dropout_rate, with_jax=False)
    v1, v2, clips, labels = (torch.tensor(a, dtype=torch.float64) if a.dtype != np.int32 else a
                             for a in _adv_inputs(arch))
    if which == "fa":
        step = anon.make_fa_step(fa, fb, ft, make_optimizer(fa.parameters(), "adam", 1e-3), p,
                                 device="cpu")
        trained = (fa,)
    else:
        step = anon.make_fbft_step(fa, fb, ft, make_optimizer(fb.parameters(), "adam", 1e-3),
                                   make_optimizer(ft.parameters(), "adam", 1e-3), p,
                                   generator=torch.Generator().manual_seed(5), device="cpu")
        trained = (fb, ft)
    losses = step(v1, v2, clips, labels)
    grads = {f"{i}{k}": v for i, m in enumerate(trained) for k, v in port_grads(m).items()}
    stats = {f"{i}{k}": v for i, m in enumerate(trained)
             for k, v in flat(state_dict_to_flax(m).get("batch_stats", {})).items()}
    return losses.numpy(), grads, stats


@pytest.mark.parametrize("which", ["fa", "fbft"])
def test_remat_gives_the_same_step_for_another_family(which):
    """With the R3D-18 ft, remat "on" (whole forwards checkpointed) and "blocks" (the
    fa's blocks on their own, the ft, which has no block boundaries, whole) give the
    step of "off": the same losses and gradients (1e-10 relative in float64), and the
    ft's BN running statistics moved once per forward."""
    ref = _port_adv_step("r3d_18", which, "off")
    for remat in ("on", "blocks"):
        losses, grads, stats = _port_adv_step("r3d_18", which, remat)
        np.testing.assert_allclose(losses, ref[0], rtol=1e-12)
        assert grads.keys() == ref[1].keys() and stats.keys() == ref[2].keys()
        for k in ref[1]:
            assert rel(grads[k], ref[1][k]) <= 1e-10, (remat, k)
        for k in ref[2]:
            assert rel(stats[k], ref[2][k]) <= 1e-12, (remat, k)


def test_i3d_dropout_masks_replay_under_remat():
    """InceptionI3d in train mode at dropout 0.5 from one seeded generator: its forward
    checkpointed whole (``remat_blocks``, what remat "blocks" gives this family, and
    what "on" gives it through the stage's checkpoint) draws the masks the plain forward
    draws, so the logits, every gradient and the running statistics agree, and the
    generator ends where one forward leaves it; a fresh draw changes the logits."""
    clip = I3D_SMALLEST_CLIP
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, 3) + clip)).double()
    ref = None
    for remat in (False, True):
        ft = load_ft_model("i3d", num_classes=N_CLASSES, dtype="float32", device="cpu")
        ft.double().requires_grad_(True)
        gen = torch.Generator().manual_seed(3)
        logits, feat = ft(x, train=True, generator=gen, remat_blocks=remat)
        (logits.square().sum() + feat.sum()).backward()
        got = (logits.detach(), {n: q.grad.clone() for n, q in ft.named_parameters()},
               {n: b.clone() for n, b in ft.named_buffers() if "running" in n}, gen.get_state())
        if ref is None:
            ref = got
            continue
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
        for k in ref[1]:
            torch.testing.assert_close(got[1][k], ref[1][k], rtol=1e-12, atol=1e-300)
        for k in ref[2]:
            torch.testing.assert_close(got[2][k], ref[2][k], rtol=0, atol=0)
        assert torch.equal(got[3], ref[3])
        other, _ = ft(x, train=True, generator=torch.Generator().manual_seed(4))
        assert not torch.allclose(other, ref[0])


