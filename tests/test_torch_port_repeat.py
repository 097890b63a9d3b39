"""Repeatability of the port's training steps, on the CPU: each step of chip_smoke.py's
phase 19 at a tiny size -- the adversarial fa step and fb/ft step (UNet++ fa,
ResNet50SSL fb, I3Res50 ft with dropout 0.5, 32^2, remat "on"), the I3Res50 action
step, fa pretraining with the UNet++ and with the plain UNet, the adversarial steps with
InceptionI3d (its smallest clip, 9 x 193^2) and with MViTv2-S (4 x 16^2), the privacy
step and the MGFN step -- run twice from the same state, batch and dropout draw through
``chip_probes``' repeat harness (the one ``chip_probes repeat`` and phase 19 run on the
card) are bit-equal in every parameter, buffer, module output and gradient at a module
output, and a change of one input value by one level shows in the harness's reading
(its control). Each step runs through the stages' deterministic cuDNN scope. JAX's steps
repeat too: ``_repeated`` in tests/test_torch_port_adversarial.py runs each of its steps
twice. So a difference between two runs on the card is the card's or the port's, not
the algorithm's."""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import pytest
import torch

from test_torch_port_adversarial import COMMON, N_PAIRS, N_VIDEOS, SIDE, T, _models

from ted_spad_tpu_torch import chip_probes
from ted_spad_tpu_torch.cli import I3D_SMALLEST_CLIP
from ted_spad_tpu_torch.config.params import (
    ActionParams, AnonymizationParams, MGFNParams, PrivacyParams, ReconstructionParams,
)
from ted_spad_tpu_torch.data.images import sample_image_augment_params
from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model
from ted_spad_tpu_torch.ops.augment import sample_augment_params
from ted_spad_tpu_torch.stages import (
    action_training, anomaly_detection, anonymization_training, fa_pretraining, privacy_training,
)

torch.set_num_threads(1)

TINY = dict(seed=0, dtype="float32", device="cpu")
MGFN_SMALL = dict(feature_size=64, dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16, batch_size=2,
                  dropout_rate=0.7)


def _adversarial(arch_ft: str = "largei3d"):
    """The adversarial steps with ``arch_ft``: the tiny UNet++ fa and ResNet50SSL fb of
    test_torch_port_adversarial.py, the tiny I3Res50 there, else the full-width family at
    its smallest clip, on seeded inputs in [0, 1]."""
    if arch_ft == "largei3d":
        p = AnonymizationParams(**dict(COMMON, remat="on"))
        (fa, fb, ft), _, _ = _models(dropout_rate=0.5, with_jax=False)
        n, clip = N_VIDEOS, (T, SIDE, SIDE)
    else:
        n, clip = {"i3d": (1, I3D_SMALLEST_CLIP), "mvitv2": (2, (4, 16, 16))}[arch_ft]
        p = AnonymizationParams(**dict(COMMON, arch_ft=arch_ft, num_frames=clip[0], reso_h=clip[1],
                                       reso_w=clip[2]))
        fa = load_fa_model(tiny=True, **TINY).requires_grad_(True)
        fb = load_fb_model(ssl=True, tiny=True, **TINY).requires_grad_(True)
        ft = load_ft_model(arch_ft, num_classes=p.num_classes, clip_shape=clip, **TINY).requires_grad_(True)
    models = {"fa": fa, "fb": fb, "ft": ft}
    g = torch.Generator().manual_seed(0)
    pairs = N_PAIRS if arch_ft == "largei3d" else 2
    v1, v2 = (torch.rand((pairs,) + clip[1:] + (3,), generator=g) for _ in range(2))
    clips = torch.rand((n, 3) + clip + (3,), generator=g)
    labels = np.array([0, 3, 0, 2][:n])
    return models, chip_probes.with_control(
        lambda i: chip_probes.repeat_steps("cpu", p, models, i), (v1, v2, clips, labels), 2)


def _action():
    p = ActionParams(num_classes=5, num_frames=T, reso_h=SIDE, reso_w=SIDE, compute_dtype="float32",
                     temporal_loss="trip", batch_size=2)
    ft = load_ft_model(num_classes=p.num_classes, dropout_rate=0.5, tiny=True, **TINY).requires_grad_(True)
    rng = np.random.default_rng(1)
    clips = torch.from_numpy(rng.integers(0, 256, (2, 3, T, 40, 48, 3), dtype=np.uint8))
    inputs = (clips, np.array([1, 4]), sample_augment_params(rng, 6, 40, 48, SIDE, SIDE))
    return {"ft": ft}, chip_probes.with_control(
        lambda i: chip_probes.action_repeat_steps("cpu", p, ft, i), inputs, 0)


def _fa_pretraining(arch: str):
    rp = ReconstructionParams(reso_h=SIDE, reso_w=SIDE, compute_dtype="float32", batch_size=2)
    fa = load_fa_model(arch, tiny=arch == "unet++", **TINY).requires_grad_(True)
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8))
    inputs = (images, sample_image_augment_params(rng, 2, 40, SIDE, SIDE))
    return {"fa": fa}, chip_probes.with_control(
        lambda i: chip_probes.fa_pretraining_repeat_steps("cpu", rp, fa, i), inputs, 0)


def _privacy():
    pp = PrivacyParams(reso_h=SIDE, reso_w=SIDE, compute_dtype="float32", batch_size=2)
    fb = load_fb_model(num_pa=pp.num_pa, tiny=True, **TINY).requires_grad_(True)
    fa = load_fa_model(tiny=True, **TINY)
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8))
    labels = rng.integers(0, 2, (2, pp.num_pa)).astype(np.float32)
    inputs = (images, labels, sample_image_augment_params(rng, 2, 40, SIDE, SIDE))
    return {"fb": fb}, chip_probes.with_control(
        lambda i: chip_probes.privacy_repeat_steps("cpu", pp, fb, fa, i), inputs, 0)


def _mgfn():
    p = MGFNParams.for_dataset("UCF").replace(**MGFN_SMALL)
    model = chip_probes.perturbed_mgfn(p, "cpu")
    return {"mgfn": model}, chip_probes.with_control(
        lambda i: chip_probes.mgfn_repeat_steps("cpu", p, model, i), chip_probes.mgfn_batch(p), 2)


# case -> (group builder, the step's name in it); a group is built once for its steps.
_GROUPS = {k: functools.cache(fn) for k, fn in {
    "largei3d": _adversarial, "i3d": functools.partial(_adversarial, "i3d"),
    "mvitv2": functools.partial(_adversarial, "mvitv2"), "action": _action,
    "unet++": functools.partial(_fa_pretraining, "unet++"), "unet": functools.partial(_fa_pretraining, "unet"),
    "privacy": _privacy, "mgfn": _mgfn}.items()}
CASES = {
    "fa step": (_GROUPS["largei3d"], "fa step"),
    "fb/ft step": (_GROUPS["largei3d"], "fb/ft step"),
    "action step": (_GROUPS["action"], "action step"),
    "fa pretraining step (UNet++)": (_GROUPS["unet++"], "fa pretraining step"),
    "fa pretraining step (UNet)": (_GROUPS["unet"], "fa pretraining step"),
    "InceptionI3d fa step": (_GROUPS["i3d"], "fa step"),
    "InceptionI3d fb/ft step": (_GROUPS["i3d"], "fb/ft step"),
    "MViTv2-S fa step": (_GROUPS["mvitv2"], "fa step"),
    "MViTv2-S fb/ft step": (_GROUPS["mvitv2"], "fb/ft step"),
    "privacy step": (_GROUPS["privacy"], "privacy step"),
    "MGFN step": (_GROUPS["mgfn"], "MGFN step"),
}


@contextlib.contextmanager
def _scopes_entered(counts: list):
    """Count the entries into the stages' deterministic cuDNN scope inside the block."""
    mods = (action_training, anomaly_detection, anonymization_training, fa_pretraining, privacy_training)
    real = [m.deterministic_cudnn for m in mods]

    @contextlib.contextmanager
    def counting():
        counts.append(1)
        with real[0]():
            yield

    for m in mods:
        m.deterministic_cudnn = counting
    try:
        yield
    finally:
        for m, fn in zip(mods, real):
            m.deterministic_cudnn = fn


@functools.cache
def _run(case: str) -> tuple:
    """(the harness's reading of the case, entries into the cuDNN scope)."""
    build, name = CASES[case]
    models, steps = build()
    counts: list = []
    with _scopes_entered(counts):
        return chip_probes.repeat_case(models, *steps[name]), len(counts)


@pytest.mark.parametrize("case", list(CASES))
def test_port_steps_repeat_bit_equal(case):
    r, scopes = _run(case)
    c = r["same"]
    assert c["loss_equal"] and c["equal"] == c["entries"] and not c["differing"]
    assert c["first_forward"] is None and c["first_backward"] is None
    assert chip_probes.repeat_gate(r) == (True, True)
    assert min(r["records"]) > 20  # the hooks saw the models, forward and backward
    assert scopes >= 3  # every run of the step went through the stage's cuDNN scope
    # One step of Adam moves each weight by about lr * sign(gradient), so the weights
    # may not show the control; its losses and the records do.
    control = r["control"]
    assert not control["loss_equal"]
    assert control["first_forward"] is not None and control["first_backward"] is not None
    assert "differ" in chip_probes.repeat_line(case, "", r)
