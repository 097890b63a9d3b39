"""Repeatability of the port's adversarial steps, on the CPU: the tiny fa step and fb/ft
step (UNet++ fa, ResNet50SSL fb, I3Res50 ft with dropout 0.5, 32^2, float32, remat
"on") run twice from the same state, batch and dropout draw through ``chip_probes``'
repeat harness (the one ``chip_probes repeat`` runs on the card) are bit-equal in
every parameter, buffer, module output and gradient at a module output, and a change
of one input pixel by one level shows in the harness's reading (its control). JAX's
steps repeat too: ``_repeated`` in tests/test_torch_port_adversarial.py runs each of its
steps twice. So a difference between two runs on the card is the card's or the
port's, not the algorithm's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_port_adversarial import COMMON, N_PAIRS, N_VIDEOS, SIDE, T, _models

from ted_spad_tpu_torch import chip_probes
from ted_spad_tpu_torch.config.params import AnonymizationParams

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_runs():
    """{step: (run, run again, run with one clip pixel moved by one level)} on seeded
    inputs in [0, 1] (VISPR views, clips of 3 views, labels with a repeated class)."""
    p = AnonymizationParams(**dict(COMMON, remat="on"))
    (fa, fb, ft), _, _ = _models(dropout_rate=0.5, with_jax=False)
    models = {"fa": fa, "fb": fb, "ft": ft}
    g = torch.Generator().manual_seed(0)
    v1, v2 = (torch.rand((N_PAIRS, SIDE, SIDE, 3), generator=g) for _ in range(2))
    clips = torch.rand((N_VIDEOS, 3, T, SIDE, SIDE, 3), generator=g)
    labels = np.array([0, 3, 0, 2])
    moved = clips.clone()
    moved.view(-1)[7] += 1 / 255
    saved = {k: {n: v.detach().clone() for n, v in m.state_dict().items()} for k, m in models.items()}
    out = {}
    for name, (make_step, run) in chip_probes.repeat_steps("cpu", p, models, (v1, v2, clips, labels)).items():
        runs = [chip_probes.repeat_run(models, saved, make_step, run) for _ in range(2)]
        _, control = chip_probes.repeat_steps("cpu", p, models, (v1, v2, moved, labels))[name]
        runs.append(chip_probes.repeat_run(models, saved, make_step, control))
        out[name] = runs
    return out


@pytest.mark.parametrize("name", ["fa step", "fb/ft step"])
def test_port_steps_repeat_bit_equal(port_runs, name):
    a, b, moved = port_runs[name]
    c = chip_probes.repeat_compare(a, b)
    assert c["loss_equal"] and c["equal"] == c["entries"] and not c["differing"]
    assert c["first_forward"] is None and c["first_backward"] is None
    assert len(a["forward"]) > 50 and len(a["backward"]) > 50  # the hooks saw the models
    # One step of Adam moves each weight by about lr * sign(gradient), so the weights
    # may not show the control; its losses and the records do.
    control = chip_probes.repeat_compare(a, moved)
    assert not control["loss_equal"]
    assert control["first_forward"] is not None and control["first_backward"] is not None
    assert "differ" in chip_probes.repeat_report(name, control)
