"""Parity of the port's training ops with ted_spad_tpu's: the training losses, top-1,
the augmentation (the draw, the resample matrices, the pixel work, frame-wise draws,
erase boxes), the optimizers against optax, the per-epoch LR control, dropout, the
train-mode models (outputs and BatchNorm statistics, FrozenBN) and the stages'
evaluation steps, from bridged weights. Inputs from seeded numpy; float32; torch on
one thread."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_port_train_stages import (
    CLIP, LOSS_RTOL, OUT_RTOL, STATS_RTOL, TINY_FT, bridged, flat, rel,
)
from ted_spad_tpu.config import params as jax_params
from ted_spad_tpu.config.params import ActionParams as JaxActionParams
from ted_spad_tpu.models import load_fa_model as jax_load_fa
from ted_spad_tpu.models import load_ft_model as jax_load_ft
from ted_spad_tpu.models.i3res50 import MlpHead as JaxMlpHead
from ted_spad_tpu.models.i3res50 import NonLocalBlock3D as JaxNonLocalBlock3D
from ted_spad_tpu.models.resnet2d import ResNet2D as JaxResNet2D
from ted_spad_tpu.ops import augment as jax_augment
from ted_spad_tpu.ops import losses as jax_losses
from ted_spad_tpu.ops.metrics import top1_accuracy as jax_top1
from ted_spad_tpu.stages import action_training as jax_action
from ted_spad_tpu.stages import common as jax_common
from ted_spad_tpu.stages import fa_pretraining as jax_fa
from ted_spad_tpu_torch.config import params
from ted_spad_tpu_torch.config.params import ActionParams
from ted_spad_tpu_torch.data.images import ReconstructionSource
from ted_spad_tpu_torch.config.paths import PathConfig
from ted_spad_tpu_torch.models import MlpHead, NonLocalBlock3D, ResNet2D, load_fa_model, load_ft_model
from ted_spad_tpu_torch.models.layers import dropout
from ted_spad_tpu_torch.ops import augment, losses
from ted_spad_tpu_torch.ops.metrics import top1_accuracy
from ted_spad_tpu_torch.stages import action_training, common, fa_pretraining
from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
AUG_ATOL = 1e-5
OPT_RTOL = 1e-6


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["StageParams", "VideoParams", "ReconstructionParams",
                                  "ActionParams", "FeatureExtractionParams"])
def test_params_match_jax(name):
    """Every field of the JAX dataclass (the extraction's: every one the port reads),
    with its default, and the schedule arrays."""
    ours, ref = getattr(params, name)(), getattr(jax_params, name)()
    want = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    got = {f.name: getattr(ours, f.name) for f in dataclasses.fields(ours)}
    assert set(got) <= set(want)
    if name != "FeatureExtractionParams":
        assert set(got) == set(want)
    assert got == {k: want[k] for k in got}
    for warmup, epochs in ((10, 100), (5, 7), (1, 3)):
        a, b = ours.replace(warmup=warmup, num_epochs=epochs), ref.replace(warmup=warmup,
                                                                           num_epochs=epochs)
        assert a.warmup_array == b.warmup_array and a.cosine_lr_array == b.cosine_lr_array
    if name == "ActionParams":
        assert ours.val_array == ref.val_array


def test_path_config_from_env(monkeypatch):
    from ted_spad_tpu.config.paths import PathConfig as JaxPathConfig

    monkeypatch.setenv("TEDSPAD_UCF101_PATH", "/x/ucf")
    ours, ref = PathConfig.from_env(), JaxPathConfig.from_env()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.ucf101_class_mapping == ref.ucf101_class_mapping == "/x/ucf/ucfTrainTestlist/action_classes.json"


# ---------------------------------------------------------------------------
# Losses and top-1
# ---------------------------------------------------------------------------


def _loss_cases():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, 5)) * 3).astype(np.float32)
    labels = rng.integers(0, 5, 6).astype(np.int32)
    targets = (rng.random((6, 5)) < 0.4).astype(np.float32)
    a, p_, n = rng.standard_normal((3, 6, 16)).astype(np.float32)
    views = rng.standard_normal((6, 2, 16)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    return {
        "l2_normalize": (lambda: losses.l2_normalize(t(a)), lambda: jax_losses.l2_normalize(a)),
        "cross_entropy": (lambda: losses.cross_entropy_loss(t(logits), t(labels)),
                          lambda: jax_losses.cross_entropy_loss(logits, labels)),
        "bce_with_logits": (lambda: losses.bce_with_logits_loss(t(logits), t(targets)),
                            lambda: jax_losses.bce_with_logits_loss(logits, targets)),
        "l1": (lambda: losses.l1_loss(t(a), t(p_)), lambda: jax_losses.l1_loss(a, p_)),
        "triplet": (lambda: losses.triplet_margin_loss(t(a), t(p_), t(n), margin=2.0),
                    lambda: jax_losses.triplet_margin_loss(a, p_, n, margin=2.0)),
        "nt_xent": (lambda: losses.nt_xent_loss(t(a), t(p_)), lambda: jax_losses.nt_xent_loss(a, p_)),
        "nt_xent_cosine": (lambda: losses.nt_xent_loss(t(a), t(p_), 0.5, True),
                           lambda: jax_losses.nt_xent_loss(a, p_, 0.5, True)),
        "supcon": (lambda: losses.supcon_loss(t(views), t(labels)),
                   lambda: jax_losses.supcon_loss(views, labels)),
    }


@pytest.mark.parametrize("name", sorted(_loss_cases()))
def test_training_losses_match_jax(name):
    """Each loss against ted_spad_tpu.ops.losses: rel 1e-5."""
    ours, ref = _loss_cases()[name]
    np.testing.assert_allclose(ours().numpy(), np.asarray(ref()), rtol=LOSS_RTOL, atol=1e-7)


def test_nt_xent_gradient_matches_jax():
    """The NT-Xent's -inf masked negatives give finite gradients equal to JAX's."""
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((2, 4, 8)).astype(np.float32)
    ga, gb = jax.grad(lambda x, y: jax_losses.nt_xent_loss(x, y), argnums=(0, 1))(a, b)
    x, y = t(a).requires_grad_(), t(b).requires_grad_()
    losses.nt_xent_loss(x, y).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ga), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(gb), rtol=1e-5, atol=1e-7)


def test_top1_accuracy_matches_jax():
    rng = np.random.default_rng(2)
    probs, labels = rng.random((20, 7)), rng.integers(0, 7, 20)
    assert top1_accuracy(probs, labels) == jax_top1(probs, labels)


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(weak=True), dict(no_ar_distortion=True),
                                dict(aspect_ratio_aug=True, min_crop=0.4)])
def test_augment_draw_matches_jax(kw):
    """The same generator gives the same draw, field by field, exactly; so does the
    frame-wise expansion."""
    ours = augment.sample_augment_params(np.random.default_rng(3), 5, 48, 64, 32, 40, **kw)
    ref = jax_augment.sample_augment_params(np.random.default_rng(3), 5, 48, 64, 32, 40, **kw)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(ours, f.name), getattr(ref, f.name), err_msg=f.name)
    ours = augment.expand_framewise(ours, 3, np.random.default_rng(4))
    ref = jax_augment.expand_framewise(ref, 3, np.random.default_rng(4))
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(ours, f.name), getattr(ref, f.name), err_msg=f.name)


@pytest.mark.parametrize("in_size,out_size,start,length", [
    (48, 32, 5, 30), (48, 32, 30, 30),   # downscale; the second box hangs past the edge
    (40, 56, 0, 40), (40, 56, 12, 24),   # upscale
    (64, 64, 0, 64),                     # identity
])
def test_scale_translate_matrix_matches_jax(in_size, out_size, start, length):
    """The numpy copy of compute_weight_mat against JAX's at scale out/length and
    translation -start * scale (as crop_resize_one passes them)."""
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    scale = np.float32(out_size) / np.float32(length)
    ref = np.asarray(compute_weight_mat(in_size, out_size, scale, -np.float32(start) * scale,
                                        _fill_triangle_kernel, True)).T
    ours = augment.scale_translate_matrix(in_size, out_size, np.array([start]), np.array([length]))[0]
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def _forced_draw(n: int, src_h: int, src_w: int, out_h: int, out_w: int, seed: int):
    """A draw with every op on for some clips: past-border crops, both erase boxes."""
    p = jax_augment.sample_augment_params(np.random.default_rng(seed), n, src_h, src_w, out_h, out_w)
    p.do_hue[:] = p.do_saturation[:] = p.do_brightness[:] = True
    p.do_contrast[0::2] = True
    p.do_grayscale[1] = p.do_gamma[1] = True
    p.do_hflip[::2] = True
    p.do_erase[:] = True
    p.y0[0], p.x0[0] = src_h - p.crop_h[0] // 2, src_w - p.crop_w[0] // 3  # taps past the border
    p.erase_y[1] = [out_h - 3, 0]  # a box clipped at the edge
    return p


@pytest.mark.parametrize("framewise", [False, True])
def test_augment_batch_matches_jax(framewise):
    """augment_batch against JAX's on the same uint8 clips and the same draw (every op
    fired somewhere; a crop whose taps pass the frame edge; two erase boxes), and in
    the frame-wise mode: 1e-5 absolute on [0, 1] images."""
    rng = np.random.default_rng(5)
    clips = rng.integers(0, 256, (4, 3, 40, 56, 3), dtype=np.uint8)
    draw = _forced_draw(4, 40, 56, 24, 32, 6)
    if framewise:
        draw = jax_augment.expand_framewise(draw, 3, np.random.default_rng(7))
    ref = np.asarray(jax_augment.augment_batch(jnp.asarray(clips), draw.to_device(), 24, 32))
    ours_draw = augment.AugmentParams(**{f.name: getattr(draw, f.name) for f in dataclasses.fields(draw)})
    ours = augment.augment_batch(t(clips), ours_draw, 24, 32).numpy()
    assert ours.shape == ref.shape == (4, 3, 24, 32, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=AUG_ATOL)
    assert (ours == 0).any() and ours.max() <= 1.0


def test_crop_resize_matches_jax_crop_resize_one():
    """The batched crop and resize against crop_resize_one per clip (windows inside,
    at the edge and past it; down- and upscaling)."""
    rng = np.random.default_rng(8)
    frames = rng.uniform(0, 1, (4, 2, 30, 44, 3)).astype(np.float32)
    y0, x0 = np.array([0, 10, 25, 3]), np.array([0, 20, 30, 1])
    ch, cw = np.array([30, 20, 18, 12]), np.array([44, 24, 30, 16])
    ours = augment.crop_resize(t(frames), y0, x0, ch, cw, 16, 20).numpy()
    for i in range(4):
        ref = jax_augment.crop_resize_one(jnp.asarray(frames[i]), jnp.asarray(y0[i]), jnp.asarray(x0[i]),
                                          jnp.asarray(ch[i]), jnp.asarray(cw[i]), 16, 20)
        np.testing.assert_allclose(ours[i], np.asarray(ref), rtol=0, atol=AUG_ATOL)


def test_colour_ops_match_jax():
    """HSV round trip and hue shift, contrast, saturation, gamma, grayscale and the
    erase box, each against its JAX function on a random clip."""
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 1, (1, 2, 6, 7, 3)).astype(np.float32)
    img[0, 0, 0, :3] = [[0.5, 0.5, 0.5], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]]  # grey, pure, black
    f = np.float32(1.07)
    cases = [
        (augment.adjust_hue(t(img), t(np.full((1, 1, 1, 1, 1), 0.04, np.float32))),
         jax_augment.adjust_hue(img[0], np.float32(0.04))),
        (augment.adjust_contrast(t(img), t(f)), jax_augment.adjust_contrast(img[0], f)),
        (augment.adjust_saturation(t(img), t(f)), jax_augment.adjust_saturation(img[0], f)),
        (augment.adjust_gamma(t(img), t(f)), jax_augment.adjust_gamma(img[0], f)),
        (augment.to_grayscale(t(img)), jax_augment.to_grayscale(img[0])),
        (augment.erase_box(t(img), *(t(np.array([v])) for v in (2, 4, 9, 2))),
         jax_augment.erase_box(img[0], 2, 4, 9, 2)),
        (augment.hsv_to_rgb(*augment.rgb_to_hsv(t(img))), img[0]),
    ]
    for ours, ref in cases:
        np.testing.assert_allclose(ours.numpy()[0], np.asarray(ref), rtol=0, atol=AUG_ATOL)


# ---------------------------------------------------------------------------
# Optimizers and LR control
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_type,weight_decay", [("adam", 0.0), ("adam", 1e-2), ("adamw", 1e-2),
                                                   ("sgd", 0.0), ("sgd", 1e-2)])
def test_optimizer_steps_match_optax(opt_type, weight_decay):
    """Two steps of each optimizer from the same parameters and gradients, with an LR
    change between them (set_learning_rate on both sides): rel 1e-6."""
    rng = np.random.default_rng(10)
    p0 = {"w": rng.standard_normal((4, 5)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(2)]
    opt = jax_common.make_optimizer(opt_type, 1e-2, weight_decay, 0.9)
    state, jp = opt.init(p0), dict(p0)
    tp = {k: torch.nn.Parameter(t(v).clone()) for k, v in p0.items()}
    topt = common.make_optimizer(tp.values(), opt_type, 1e-2, weight_decay, 0.9)
    for i, lr in enumerate((1e-2, 3e-3)):
        jax_common.set_learning_rate(state, lr)
        common.set_learning_rate(topt, lr)
        updates, state = opt.update(grads[i], state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in tp.items():
            v.grad = t(grads[i][k]).clone()
        topt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=OPT_RTOL,
                                       atol=1e-7, err_msg=f"{opt_type} step {i} {k}")


@pytest.mark.parametrize("mode", ["cosine", "patience_based", "loss_based", "warmup_drop",
                                  "warmup_only"])
def test_lr_scheduler_matches_jax(mode):
    """30 epochs of a loss trace with plateaus and rises: the same LR every epoch.
    ``warmup_only`` is a mode the loop does not name: the warmup ramp, then the base LR."""
    rng = np.random.default_rng(11)
    trace = np.concatenate([np.linspace(2.0, 0.05, 12), np.full(6, 0.05), rng.uniform(0.05, 1.5, 12)])
    for cls, mod in ((params.ReconstructionParams, jax_params.ReconstructionParams),
                     (params.ActionParams, jax_params.ActionParams)):
        kw = dict(lr_scheduler=mode, num_epochs=30, learning_rate=1e-3, warmup=4, lr_patience=1)
        ours, ref = common.LRScheduler(cls(**kw)), jax_common.LRScheduler(mod(**kw))
        loss = None
        for epoch in range(1, 31):
            assert ours.epoch_lr(epoch, loss) == ref.epoch_lr(epoch, loss), (cls.__name__, epoch)
            loss = float(trace[epoch - 1])
            ours.update(loss)
            ref.update(loss)
            assert ours.patience_count == ref.patience_count


def test_tree_finite():
    m = torch.nn.Linear(3, 2)
    assert common.tree_finite(m) and common.tree_finite([torch.ones(2), torch.arange(3)])
    with torch.no_grad():
        m.bias[0] = float("nan")
    assert not common.tree_finite(m)


def test_dropout_keep_rate_and_scale():
    """flax Dropout(0.5): kept with p = 0.5 (share 0.5 +- 0.01 over 4e4 draws), kept
    values x / 0.5, the same generator seed the same mask, the identity at rate 0,
    and no draw without a generator."""
    x = torch.full((200, 200), 3.0)
    out = dropout(x, 0.5, torch.Generator().manual_seed(1))
    kept = out[out != 0]
    assert abs(kept.numel() / x.numel() - 0.5) <= 0.01
    assert torch.equal(kept, torch.full_like(kept, 6.0))
    assert torch.equal(out, dropout(x, 0.5, torch.Generator().manual_seed(1)))
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, None)


# ---------------------------------------------------------------------------
# Train-mode models
# ---------------------------------------------------------------------------


def _train_forward_pair(name: str, frozen: bool):
    """(port module, flax module, flax variables, input NHWC/NDHWC numpy, port
    forward, flax apply kwargs)."""
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    if name == "resnet2d":
        port, jm = ResNet2D("basic", (1, 1, 1, 1), 4, 8, generator=g), JaxResNet2D(
            block="basic", layers=(1, 1, 1, 1), depth=4, width=8)
        x = rng.uniform(0, 1, (3, 32, 32, 3))
    elif name == "unet++":
        port, jm = load_fa_model(tiny=True, dtype="float32", device="cpu"), jax_load_fa(
            image_size=(32, 32), dtype="float32", tiny=True)[0]
        x = rng.uniform(0, 1, (3, 32, 32, 3))
    elif name == "unet":
        port, jm = load_fa_model("unet", dtype="float32", device="cpu"), jax_load_fa(
            arch="unet", image_size=(32, 32), dtype="float32")[0]
        x = rng.uniform(0, 1, (2, 32, 32, 3))
    elif name == "i3res50":
        port, jm = load_ft_model(dtype="float32", device="cpu", **TINY_FT), jax_load_ft(
            clip_shape=CLIP, dtype="float32", **TINY_FT)[0]
        # Clips of different brightness: pooled features that differ between clips, so
        # the MLP head's batch statistics over 4 clips are well conditioned.
        x = rng.uniform(0, 1, (4,) + CLIP + (3,)) * np.array([0.1, 0.5, 1.5, 3.0])[:, None, None, None, None]
    elif name == "mlp":
        port, jm = MlpHead(24, generator=g), JaxMlpHead()
        x = rng.standard_normal((6, 24))
    else:  # nonlocal
        port, jm = NonLocalBlock3D(16, generator=g), JaxNonLocalBlock3D(16)
        x = rng.standard_normal((2, 2, 4, 6, 16))
    port, tree = bridged(port, 2)
    x = x.astype(np.float32)
    perm = {2: (0, 1), 4: (0, 3, 1, 2), 5: (0, 4, 1, 2, 3)}[x.ndim]
    kw = {"frozen_bn": True} if frozen else {}
    if name in ("resnet2d", "unet++", "unet", "mlp"):
        fwd = lambda m, v: m(v, train=True)  # noqa: E731
    else:
        fwd = lambda m, v: m(v, train=True, frozen_bn=frozen)  # noqa: E731
    return port, jm, tree, x, torch.from_numpy(x).permute(*perm).contiguous(), fwd, kw


def _nhwc(t):
    if isinstance(t, torch.Tensor) and t.dim() in (4, 5):
        return t.permute(0, *range(2, t.dim()), 1).numpy()
    return t.numpy()


@pytest.mark.parametrize("name,frozen", [("resnet2d", False), ("unet++", False), ("unet", False),
                                         ("i3res50", False), ("i3res50", True), ("mlp", False),
                                         ("nonlocal", False), ("nonlocal", True)])
def test_train_mode_forward_matches_flax(name, frozen):
    """One train-mode forward: outputs rel 1e-4, the updated running statistics rel
    1e-5 (biased variance, momentum 0.9); with frozen_bn the backbone's statistics do
    not move (only the MLP head's, which never freezes)."""
    port, jm, tree, x, xt, fwd, kw = _train_forward_pair(name, frozen)
    before = flat(tree.get("batch_stats", {}))
    ref, mutated = jm.apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), train=True,
                            mutable=["batch_stats"], **kw)
    with torch.no_grad():
        ours = fwd(port, xt)
    refs = ref if isinstance(ref, (list, tuple)) else [ref]
    outs = ours if isinstance(ours, (list, tuple)) else [ours]
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        assert rel(_nhwc(o), np.asarray(r)) <= OUT_RTOL
    got, want = flat(state_dict_to_flax(port).get("batch_stats", {})), flat(mutated["batch_stats"])
    assert got.keys() == want.keys() == before.keys()
    moved = 0
    for k in want:
        assert rel(got[k], want[k]) <= STATS_RTOL, k
        if not np.array_equal(got[k], before[k]):
            moved += 1
            assert not (frozen and "['mlp']" not in k), k
    assert moved > 0 if not frozen or name == "i3res50" else moved == 0


def test_unet_train_mode_runs_no_kernel_path(monkeypatch):
    """A train-mode UNet DoubleConv runs its ConvBNs unfolded: fused_double_conv and
    fold_bn are never reached (K2 has no backward and folds eval-mode BN)."""
    import ted_spad_tpu_torch.models.unet as unet_mod

    def refuse(*a, **k):
        raise AssertionError("the K2 path ran in train mode")

    monkeypatch.setattr(unet_mod, "fused_double_conv", refuse)
    monkeypatch.setattr(unet_mod, "double_conv_reference", refuse)
    monkeypatch.setattr(unet_mod, "fold_bn", refuse)
    fa = load_fa_model("unet", dtype="float32", device="cpu").requires_grad_(True)
    fa(torch.rand(2, 3, 16, 16), train=True).mean().backward()
    assert fa.inc.conv1.conv.weight.grad is not None


def test_ft_dropout_draws_from_the_generator():
    """At the module default rate (0.5, what ft_dropout == 0 selects) the logits depend
    on the generator's seed and repeat with it; the embedding does not see dropout."""
    ft = load_ft_model(dtype="float32", device="cpu", tiny=True, num_classes=5)
    assert ft.i3d.dropout_rate == 0.5
    x = torch.rand(2, 3, *CLIP)
    with torch.no_grad():
        a = ft(x, train=True, frozen_bn=True, generator=torch.Generator().manual_seed(1))
        b = ft(x, train=True, frozen_bn=True, generator=torch.Generator().manual_seed(1))
        c = ft(x, train=True, frozen_bn=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    with pytest.raises(ValueError, match="Generator"):
        ft(x, train=True, frozen_bn=True)


# Evaluation steps


def test_eval_steps_match_jax():
    """fa: the L1, reconstruction and centre square of make_eval_step. ft: the softmax
    of the centre view at crop factors 0.8 and 1 (reso / 0.8, uncropped), mirrored,
    three-crop, and through a frozen fa with quirk_compat: 1e-4."""
    fa, fa_tree = bridged(load_fa_model(tiny=True, dtype="float32", device="cpu"), 8)
    jfa = jax_load_fa(image_size=(32, 32), dtype="float32", tiny=True)[0]
    images = ReconstructionSource(synthetic_n=3, seed=2, canonical=40).get_batch([0, 1, 2])[0]
    jl, jrecon, jimg = jax_fa.make_eval_step(jfa, (32, 32))(jax.tree_util.tree_map(jnp.asarray, fa_tree),
                                                          jnp.asarray(images))
    l1, recon, img = fa_pretraining.make_eval_step(fa, (32, 32), compute_dtype="float32", device="cpu")(images)
    assert abs(float(l1) - float(jl)) <= LOSS_RTOL * float(jl)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-5, rtol=0)
    assert rel(recon.numpy(), np.asarray(jrecon)) <= OUT_RTOL

    ft, tree = bridged(load_ft_model(dtype="float32", device="cpu", **TINY_FT), 9)
    jft = jax_load_ft(clip_shape=CLIP, dtype="float32", **TINY_FT)[0]
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    clips = np.random.default_rng(10).integers(0, 256, (2, 1, 8, 40, 48, 3), dtype=np.uint8)
    common = dict(num_classes=5, num_frames=8, reso_h=32, reso_w=32, compute_dtype="float32")
    for extra, fa_on, three in (({}, False, False), ({}, False, True),
                                ({"anonymized": True, "quirk_compat": True}, True, False)):
        p, jp = ActionParams(**common, **extra), JaxActionParams(**common, **extra)
        jfa_pair = (jfa, jax.tree_util.tree_map(jnp.asarray, fa_tree)) if fa_on else None
        jstep = jax_action.make_eval_step(jft, jp, jfa_pair, three_crop=three)
        step = action_training.make_eval_step(ft, p, fa if fa_on else None, three_crop=three, device="cpu")
        # (cf 1 evaluates at reso / 0.8 = 40, which a UNet++ fa cannot take: 40 / 16 is
        # not whole, in either package.)
        for cf, hf in ((0.8, False), (0.8, True)) + (() if fa_on else ((1.0, False),)):
            ref = np.asarray(jstep(jtree, jnp.asarray(clips), cropping_factor=cf, hflip=hf))
            ours = step(clips, cf, hf).numpy()
            np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0, err_msg=f"{extra} {three} {cf} {hf}")
