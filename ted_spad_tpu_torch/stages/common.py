"""Shared stage machinery (counterpart of ted_spad_tpu/stages/common.py): torch
optimizers that compute the JAX package's optax chains, the host-side per-epoch
learning rate (set between epochs, the moments untouched), the epoch's mean loss, a
finiteness check, and what the train steps share (device check, autocast to the
compute dtype, zero gradients for parameters the loss does not reach)."""

from __future__ import annotations

import contextlib
from typing import Iterable, Sequence

import torch

from ted_spad_tpu_torch.utils.device import resolve_device, torch_dtype


def make_optimizer(params: Iterable[torch.nn.Parameter], opt_type: str = "adam",
                   learning_rate: float = 1e-4, weight_decay: float = 0.0,
                   momentum: float = 0.9) -> torch.optim.Optimizer:
    """The JAX package's ``make_optimizer`` chains (train_anonymizer.py:377-388;
    train_action.py:221-226) as torch optimizers:

    - ``adam``: ``add_decayed_weights -> scale_by_adam -> scale(-lr)``, i.e. L2 added
      to the gradient before the moments: torch ``Adam``'s ``weight_decay``;
    - ``adamw``: ``scale_by_adam -> add_decayed_weights -> scale(-lr)``, decay
      decoupled from the moments and taken from the pre-step parameters: torch ``AdamW``;
    - ``sgd``: ``[add_decayed_weights] -> trace(momentum) -> scale(-lr)``, momentum
      without dampening: torch ``SGD``.

    Adam's betas (0.9, 0.999) and eps 1e-8 outside the square root are optax's."""
    if opt_type == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if opt_type == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if opt_type == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum, dampening=0.0,
                               weight_decay=weight_decay)
    raise ValueError(f"unknown opt_type {opt_type!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set the learning rate of every parameter group; the optimizer's moments are
    untouched (the JAX package mutates ``inject_hyperparams``' LR the same way)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


class LRScheduler:
    """Per-epoch LR control of the reference's loops: ``cosine``, a warmup ramp, then
    ``loss_based`` or ``patience_based`` (train_action.py:300-318), and ``warmup_drop``
    (train_reconstruction.py:138-161, train_privacy.py:197-210). Call ``epoch_lr``
    before each epoch and ``update`` after it with the train loss."""

    def __init__(self, params):
        self.p = params
        self.base_lr = params.learning_rate
        self.best_loss = float("inf")
        self.patience_count = 0
        self.scheduler_step = 1
        self.lr = self.base_lr

    def epoch_lr(self, epoch: int, train_loss: float | None = None) -> float:
        p = self.p
        mode = getattr(p, "lr_scheduler", "cosine")
        if mode == "cosine":
            arr = p.cosine_lr_array
            self.lr = arr[min(epoch - 1, len(arr) - 1)] * self.base_lr
        elif mode != "warmup_drop" and getattr(p, "warmup", 0) and epoch - 1 < len(p.warmup_array):
            self.lr = p.warmup_array[epoch - 1] * self.base_lr
        elif mode == "loss_based" and train_loss is not None:
            if 0.5 <= train_loss < 1.0:
                self.lr = self.base_lr / 2
            elif 0.1 <= train_loss < 0.5:
                self.lr = self.base_lr / 10
            elif train_loss < 0.1:
                self.lr = self.base_lr / 20
        elif mode == "patience_based":
            if self.patience_count >= p.lr_patience:
                self.lr = self.base_lr / (p.lr_reduce_factor ** self.scheduler_step)
                self.patience_count = 0
                self.scheduler_step += 1
        elif mode == "warmup_drop":
            # warmup_array[epoch] while epoch < warmup (the 1-based epoch skips index 0,
            # as the reference), then a division by the stage's drop factor once more
            # than lr_patience non-improving epochs have accumulated. The count is
            # cumulative: these loops reset it only after a drop fires.
            if epoch < getattr(p, "warmup", 0):
                self.lr = p.warmup_array[min(epoch, len(p.warmup_array) - 1)] * self.base_lr
            if self.patience_count > p.lr_patience:
                self.patience_count = 0
                drop = getattr(p, "scheduled_drop", None) or getattr(p, "lr_reduce_factor", 5)
                self.lr = self.lr / drop
        return self.lr

    def update(self, train_loss: float) -> None:
        if train_loss < self.best_loss:
            self.best_loss = train_loss
            if getattr(self.p, "lr_scheduler", "") == "patience_based":
                self.patience_count = 0
        else:
            self.patience_count += 1


def tree_finite(tensors: torch.nn.Module | Iterable[torch.Tensor]) -> bool:
    """Whether every floating tensor (a module's parameters and buffers) is finite."""
    if isinstance(tensors, torch.nn.Module):
        tensors = list(tensors.parameters()) + list(tensors.buffers())
    return all(bool(torch.isfinite(t).all()) for t in tensors if t.is_floating_point())


def epoch_mean(losses: Sequence[torch.Tensor | float]) -> float:
    """Mean of per-step losses, read from the device once per epoch: training loops
    keep the raw device scalars, since ``float(loss)`` in the loop would wait for
    the device every step."""
    if not losses:
        return float("nan")
    return float(torch.stack([torch.as_tensor(x).detach().float().cpu() for x in losses]).mean())


def module_device(model: torch.nn.Module, device) -> torch.device:
    """``device`` resolved, after checking that ``model`` lives there."""
    device = resolve_device(device)
    have = next(model.parameters()).device
    if have != device:
        raise ValueError(f"model on {have}, step on {device}")
    return device


def autocast(device: torch.device, compute_dtype: str | None):
    """Autocast to ``compute_dtype`` (bf16 convolutions and matmuls over float32
    parameters, the JAX modules' ``dtype``), or nothing for float32."""
    dtype = torch_dtype(compute_dtype)
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def augment_dtype(model: torch.nn.Module) -> torch.dtype:
    """The augmentation's dtype: float32, as the JAX package's; float64 for a float64
    model (a reference step)."""
    return torch.float64 if next(model.parameters()).dtype == torch.float64 else torch.float32


def zero_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """A zero gradient for every parameter the loss did not reach (the classifier
    under ``loss='con'``, the MLP head under plain cross entropy), as ``jax.grad``
    gives: the optimizer then still applies weight decay and moves its moments, as
    the optax chains do; torch would skip those parameters."""
    for group in optimizer.param_groups:
        for param in group["params"]:
            if param.grad is None:
                param.grad = torch.zeros_like(param)
