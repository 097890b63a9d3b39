"""Shared stage machinery (counterpart of ted_spad_tpu/stages/common.py): the
host-side per-epoch learning rate and the epoch's mean loss."""

from __future__ import annotations

from typing import Sequence

import torch


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set the learning rate of every parameter group; the optimizer's moments are
    untouched (the JAX package mutates ``inject_hyperparams``' LR the same way)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


def epoch_mean(losses: Sequence[torch.Tensor | float]) -> float:
    """Mean of per-step losses, read from the device once per epoch: training loops
    keep the raw device scalars, since ``float(loss)`` in the loop would wait for
    the device every step."""
    if not losses:
        return float("nan")
    return float(torch.stack([torch.as_tensor(x).detach().float().cpu() for x in losses]).mean())
