"""Parity of the port's action training with the ft families beside I3Res50 --
InceptionI3d (``"i3d"``), R3D-18 (``"r3d_18"``) and MViTv2-S (``"mvitv2"``), each at full
width -- with ted_spad_tpu's, from bridged weights at dropout 0, on the CPU: one action
step of each family, its trained tree through both packages' checkpoints, the next step
from a checkpoint either package wrote, the train_action driver with cross-loaded
checkpoints, and the CLIs with another family. (The adversarial steps with these
families are test_torch_port_ft_adversarial.py's.)

i3d runs at its smallest clip, 9x193x193, with one video; r3d_18 and mvitv2 at 4x16x16
with two. The steps are held in float64 on both sides (JAX under ``enable_x64``) to the
limits of test_torch_port_train_stages.py (stated there). Torch on one thread."""

from __future__ import annotations

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_adversarial import _dev, _with_grads
from test_torch_port_train_stages import as_port_draw, bridged, check_step, flat

from ted_spad_tpu.config.params import ActionParams as JaxActionParams
from ted_spad_tpu.data import videos as jax_videos
from ted_spad_tpu.models import load_ft_model as jax_load_ft
from ted_spad_tpu.models.i3d import InceptionI3d as JaxInceptionI3d
from ted_spad_tpu.models.mvit import MViTv2S as JaxMViTv2S
from ted_spad_tpu.models.r3d import R3D18 as JaxR3D18
from ted_spad_tpu.ops import augment as jax_augment
from ted_spad_tpu.stages import action_training as jax_action
from ted_spad_tpu.stages.common import make_optimizer as jax_make_optimizer
from ted_spad_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from ted_spad_tpu.utils.checkpoint import restore_like as jax_restore_like
from ted_spad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from ted_spad_tpu_torch import train_action as train_action_cli
from ted_spad_tpu_torch import train_anonymizer as train_anonymizer_cli
from ted_spad_tpu_torch.cli import I3D_SMALLEST_CLIP
from ted_spad_tpu_torch.config.params import ActionParams
from ted_spad_tpu_torch.data.videos import synthetic_video_items
from ted_spad_tpu_torch.models import FT_FEATURE_DIMS, load_ft_model
from ted_spad_tpu_torch.stages import action_training
from ted_spad_tpu_torch.stages import anonymization_training as anon
from ted_spad_tpu_torch.stages.common import make_optimizer
from ted_spad_tpu_torch.utils.checkpoint import save_checkpoint
from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax

torch.set_num_threads(1)

FAMILIES = ("i3d", "r3d_18", "mvitv2")
CLIPS = {"i3d": (1, I3D_SMALLEST_CLIP), "r3d_18": (2, (4, 16, 16)), "mvitv2": (2, (4, 16, 16))}
N_CLASSES = 5


def _jax_ft(arch: str, dtype: str, dropout_rate: float = 0.0):
    """The JAX ft module (its variables come from the port, so no init is traced)."""
    dt = jnp.dtype(dtype)
    if arch == "i3d":
        return JaxInceptionI3d(num_classes=N_CLASSES, dropout_rate=dropout_rate, dtype=dt)
    return {"r3d_18": JaxR3D18, "mvitv2": JaxMViTv2S}[arch](num_classes=N_CLASSES, dtype=dt)


def _ft(arch: str, clip, dtype: str = "float64", dropout_rate: float = 0.0, seed: int = 21):
    """(port ft with perturbed weights in ``dtype``, requiring grad; the same weights as
    a flax tree in ``dtype``; the JAX module in ``dtype``). InceptionI3d's 1x1x1
    classifier is drawn 20x narrower: at its kaiming init (std sqrt(2 / classes)) the
    logits are so wide that cross entropy saturates at 0 and passes no gradient."""
    kw = dict(num_classes=N_CLASSES, clip_shape=clip,
              dropout_rate=dropout_rate if arch == "i3d" else None)
    ft = load_ft_model(arch, dtype="float32", device="cpu", **kw)
    if arch == "i3d":
        with torch.no_grad():
            ft.logits_conv.weight.mul_(0.05)
    ft, tree = bridged(ft, seed)
    ft.to(getattr(torch, dtype)).requires_grad_(True)
    tree = jax.tree_util.tree_map(lambda a: a.astype(dtype), tree)
    return ft, tree, _jax_ft(arch, dtype, dropout_rate)


def _clip_batch(b: int, clip, seed: int):
    """(uint8 clips (b, 3, T, H, W, 3), labels, a draw of 3b augmentations that keeps
    every frame whole (crop = frame, no colour ops or erasing) and mirrors two views of
    three). The pixels are 0 or 255, at a density that differs by view, so that both
    packages' augmentations give their models the same pixels: JAX's puts one float32
    rounding (up to 1.5e-8) on other values, and a full-width InceptionI3d step with
    BN's batch statistics over three clips moves some gradients by 7e-3 for an input
    change of 1e-7."""
    t, h, w = clip
    rng = np.random.default_rng(seed)
    density = np.linspace(0.2, 0.8, 3 * b).reshape(b, 3)[:, :, None, None, None, None]
    clips = np.where(rng.random((b, 3, t, h, w, 3)) < density, 255, 0).astype(np.uint8)
    labels = np.array([0, 3][:b], np.int32)
    draw = jax_augment.sample_augment_params(rng, 3 * b, h, w, h, w, weak=True)
    draw.y0[:] = draw.x0[:] = 0
    draw.crop_h[:], draw.crop_w[:] = h, w
    draw.do_hflip = np.array([True, False, True] * b)  # weak draws share one "off" array
    return clips, labels, draw


def _action_params(arch: str, clip, **extra):
    t, h, w = clip
    kw = dict(arch=arch, num_classes=N_CLASSES, num_frames=t, reso_h=h, reso_w=w,
              compute_dtype="float32", temporal_loss="trip", learning_rate=1e-3,
              weight_decay=1e-2, **extra)
    return ActionParams(**kw), JaxActionParams(**kw)


@functools.lru_cache(maxsize=None)
def _jax_action_step_fn(arch: str):
    """(JAX module, optimizer, JAX's jitted make_train_step) of the family in float64,
    built once per family: its trace and compile are most of a test's time."""
    _, clip = CLIPS[arch]
    jft = _jax_ft(arch, "float64")
    jp = _action_params(arch, clip)[1]
    opt = _with_grads(jax_make_optimizer(jp.opt_type, jp.learning_rate, jp.weight_decay, jp.momentum))
    return opt, jax_action.make_train_step(jft, opt, jp)


def _jax_action_step(arch: str, tree, clips, labels, draw):
    """JAX's action step from ``tree`` in float64: (new variables as numpy, gradients, loss)."""
    with jax.enable_x64(True):
        opt, step = _jax_action_step_fn(arch)
        state = _dev(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree))
        new, (_, grads), loss = step(state, opt.init(state["params"]), jax.random.PRNGKey(0),
                                     jnp.asarray(clips), jnp.asarray(labels), draw.to_device())
        return jax.tree_util.tree_map(np.asarray, new), flat(grads), float(loss)


def _port_action_step(ft, p, clips, labels, draw):
    """The port's make_train_step, augmenting in float32 as JAX does for any model (the
    port's own default for a float64 model is float64)."""
    opt = make_optimizer(ft.parameters(), p.opt_type, p.learning_rate, p.weight_decay, p.momentum)
    with mock.patch.object(action_training, "augment_dtype", lambda model: torch.float32):
        step = action_training.make_train_step(ft, opt, p, device="cpu")
    return step(clips, labels, as_port_draw(draw))


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _same_tree(a, b) -> None:
    a, b = flat(a), flat(b)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("arch", FAMILIES)
def test_action_step_matches_jax(arch, tmp_path):
    """One action training step ('trip': three views through one batched train-mode
    forward, cross entropy on the first view's logits plus 0.1 x the triplet loss on the
    family's own feature, 1024 / 512 / 768 wide; Adam with coupled L2) against JAX's
    make_train_step at dropout 0, in float64: the loss, every gradient, the parameters
    after Adam and every BN statistic (InceptionI3d's at momentum 0.99; MViTv2-S has
    none). Then the trained trees cross the bridge both ways: JAX's variables after the
    step, in a checkpoint JAX wrote, load into the port's load_ft_model, and the port's,
    in a checkpoint the port wrote, into JAX's restore, bit-equal to the float32 the
    files hold (BN statistics, i3d's ``logits_conv``, r3d's ``fc``, mvit's ``head``)."""
    b, clip = CLIPS[arch]
    p, _ = _action_params(arch, clip)
    clips, labels, draw = _clip_batch(b, clip, seed=1)
    with jax.enable_x64(True):
        ft, tree, _ = _ft(arch, clip)
    new, jgrads, jloss = _jax_action_step(arch, tree, clips, labels, draw)
    loss = _port_action_step(ft, p, clips, labels, draw)
    check_step(ft, loss, jloss, jgrads, flat(tree["params"]), new["params"],
               new.get("batch_stats", {}), coupled_decay=p.weight_decay)
    assert ft(torch.zeros((1, 3) + clip, dtype=torch.float64))[1].shape == (1, FT_FEATURE_DIMS[arch])

    jax_path, port_path = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jax_save_checkpoint(jax_path, {"ft_model_state_dict": _f32(new)})
    loaded = load_ft_model(arch, saved_model_file=jax_path, num_classes=N_CLASSES, clip_shape=clip,
                           dtype="float32", device="cpu")
    _same_tree(state_dict_to_flax(loaded), _f32(new))
    ours = state_dict_to_flax(ft)
    save_checkpoint(port_path, {"ft_model_state_dict": ours})
    _same_tree(jax_restore_like(_f32(tree), jax_load_checkpoint(port_path)["ft_model_state_dict"]), ours)


def test_checkpoints_after_a_step_give_the_same_next_step(tmp_path):
    """R3D-18: from a checkpoint JAX wrote after a step, and from one the port wrote
    after the same step, both packages take the next step alike (loss, gradients,
    parameters, BN statistics), each loading the file with its own loader."""
    b, clip = CLIPS["r3d_18"]
    p, _ = _action_params("r3d_18", clip)
    first, second = (_clip_batch(b, clip, seed=s) for s in (2, 3))
    with jax.enable_x64(True):
        ft, tree, _ = _ft("r3d_18", clip)
    new, _, _ = _jax_action_step("r3d_18", tree, *first)
    _port_action_step(ft, p, *first)
    paths = {"jax": str(tmp_path / "jax.ckpt"), "port": str(tmp_path / "port.ckpt")}
    jax_save_checkpoint(paths["jax"], {"ft_model_state_dict": _f32(new)})
    save_checkpoint(paths["port"], {"ft_model_state_dict": state_dict_to_flax(ft)})
    for who, path in paths.items():
        loaded = load_ft_model("r3d_18", saved_model_file=path, num_classes=N_CLASSES, clip_shape=clip,
                               dtype="float32", device="cpu").double().requires_grad_(True)
        start = jax_restore_like(tree, jax_load_checkpoint(path)["ft_model_state_dict"])
        jnext, jgrads, jloss = _jax_action_step("r3d_18", start, *second)
        loss = _port_action_step(loaded, p, *second)
        check_step(loaded, loss, jloss, jgrads, flat(start["params"]), jnext["params"],
                   jnext["batch_stats"], coupled_decay=p.weight_decay)


# ---------------------------------------------------------------------------
# The driver and the CLIs
# ---------------------------------------------------------------------------


def test_train_action_r3d_matches_jax_and_cross_loads(tmp_path):
    """A one-epoch synthetic train_action run with the R3D-18 ft ('trip', 4x16x16) in
    each package: the same history lengths, finite losses, and each package's best
    checkpoint loading bit-equal in the other's load_ft_model."""
    kw = dict(arch="r3d_18", run_id="r3d", num_classes=4, num_frames=4, reso_h=16, reso_w=16,
              batch_size=4, v_batch_size=4, num_modes=1, temporal_loss="trip",
              compute_dtype="float32")
    items = dict(train_items=synthetic_video_items(8, 4, num_frames=40, h=40, w=48, seed=0),
                 val_items=synthetic_video_items(4, 4, num_frames=40, h=40, w=48, seed=1),
                 max_epochs=1, log_fn=lambda s: None)
    ours = action_training.train_action(ActionParams(**kw), save_dir=str(tmp_path / "p"), device="cpu",
                                        **items)
    jitems = dict(items, train_items=[jax_videos.VideoItem(i.uri, i.label) for i in items["train_items"]],
                  val_items=[jax_videos.VideoItem(i.uri, i.label) for i in items["val_items"]])
    ref = jax_action.train_action(JaxActionParams(**kw), save_dir=str(tmp_path / "j"), **jitems)
    assert {k: len(v) for k, v in ours["history"].items()} == {k: len(v) for k, v in ref["history"].items()} \
        == {"train_loss": 1, "val_acc": 1}
    assert np.isfinite(ours["history"]["train_loss"]).all() and 0 <= ours["best_acc"] <= 1
    for path in (ours["best_path"], ref["best_path"]):
        port_ft = load_ft_model("r3d_18", saved_model_file=path, num_classes=4, dtype="float32",
                                device="cpu")
        _, jvars = jax_load_ft("r3d_18", path, num_classes=4, clip_shape=(4, 16, 16), dtype="float32")
        a, b = flat(state_dict_to_flax(port_ft)), flat(jvars)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_clis_train_other_families(tmp_path, monkeypatch):
    """``train_action --synthetic --device cpu --arch r3d_18`` and ``train_anonymizer
    --synthetic --device cpu`` with ``arch_ft = "mvitv2"`` from ``--params`` each run one
    epoch and write their checkpoints; ``--synthetic`` gives an i3d ft its smallest clip
    in both CLIs (the runs themselves stubbed: the clip is all that is checked)."""
    res = train_action_cli.run(train_action_cli.parser().parse_args(
        ["--synthetic", "--device", "cpu", "--epochs", "1", "--arch", "r3d_18",
         "--save_dir", str(tmp_path / "a")]))
    assert res["best_path"] and np.isfinite(res["history"]["train_loss"]).all()
    assert type(res["model"]).__name__ == "R3D18"
    params = tmp_path / "p.py"
    params.write_text('arch_ft = "mvitv2"\n')
    res = train_anonymizer_cli.run(train_anonymizer_cli.parser().parse_args(
        ["--synthetic", "--device", "cpu", "--epochs", "1", "--params", str(params),
         "--save_dir", str(tmp_path / "b")]))
    assert res["best_path"] and type(res["ft"]).__name__ == "MViTv2S"
    assert all(np.isfinite(v).all() for v in res["history"].values())

    seen = []
    monkeypatch.setattr(action_training, "train_action", lambda p, **kw: seen.append(p) or
                        {"best_acc": 0.0, "best_path": None})
    monkeypatch.setattr(anon, "train_anonymizer", lambda p, **kw: seen.append(p) or
                        {"best_acc": 0.0, "best_path": None})
    params.write_text('arch = "i3d"\narch_ft = "i3d"\n')
    for cli in (train_action_cli, train_anonymizer_cli):
        cli.run(cli.parser().parse_args(["--synthetic", "--device", "cpu", "--params", str(params)]))
    assert [(q.num_frames, q.reso_h, q.reso_w) for q in seen] == [I3D_SMALLEST_CLIP] * 2
