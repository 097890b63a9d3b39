"""Privacy-attack evaluation: a fresh ResNet-50 multi-label classifier (fb) trained on
VISPR, plain or through a frozen anonymizer, and scored by cMAP; a lower cMAP after
anonymization is more privacy (counterpart of ted_spad_tpu/stages/privacy_training.py;
reference privacy_training/train_privacy.py -- train_epoch :29, val_epoch :70,
train_classifier :136).

- A train step: the host's augmentation draw applied on the card (ops/augment.py),
  with ``anon`` the frozen fa in eval mode under ``no_grad`` (the JAX package's
  ``stop_gradient``; a plain-UNet fa runs its DoubleConvs through kernel K2 on the
  card), the fb classifier in train mode (flax BatchNorm semantics), BCE with logits
  and Adam. The fb's convolutions and matmuls run in ``compute_dtype`` under autocast
  over float32 parameters.
- An eval step: the centre square resized (``no_ar_distortion``), the frozen fa, and
  the sigmoid scores in float32.
- Per-epoch LR: ``warmup_drop`` at ``learning_rate / 5`` (train_privacy.py:197-213).
  Metrics over the whole validation split: cMAP with the per-class AP, and macro
  precision / recall / F1 at 0.5.
- Checkpoints (flax msgpack, the JAX package's layout): the best cMAP with the
  prediction scores, the ground truth and the per-class AP, and a rolling
  ``model_temp.ckpt``. An epoch that fails is logged and skipped; the history's lists
  are padded with NaN so they stay aligned by epoch.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from ted_spad_tpu_torch.config.params import PrivacyParams
from ted_spad_tpu_torch.data.images import vispr_batches
from ted_spad_tpu_torch.data.prefetch import prefetch
from ted_spad_tpu_torch.models import load_fa_model, load_fb_model
from ted_spad_tpu_torch.ops.augment import AugmentParams, augment_batch, center_crop_resize
from ted_spad_tpu_torch.ops.losses import bce_with_logits_loss
from ted_spad_tpu_torch.ops.metrics import macro_average_precision, multilabel_prf1
from ted_spad_tpu_torch.stages.common import (
    LRScheduler, augment_dtype, autocast, epoch_mean, make_optimizer, module_device, set_learning_rate,
    zero_missing_grads,
)
from ted_spad_tpu_torch.utils.checkpoint import BestCheckpointer, flush_checkpoints, save_temp
from ted_spad_tpu_torch.utils.device import resolve_device
from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax
from ted_spad_tpu_torch.utils.logging import MetricsWriter


def anonymize(fa: torch.nn.Module | None, img: torch.Tensor) -> torch.Tensor:
    """The frozen fa in eval mode over (B, H, W, 3) images, without gradients ->
    (B, H, W, 3) float32 (the images themselves without an fa)."""
    if fa is None:
        return img
    with torch.no_grad():
        return fa(img.permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1)


def make_steps(fb: torch.nn.Module, fa: torch.nn.Module | None, optimizer: torch.optim.Optimizer,
               out_hw: tuple[int, int], *, compute_dtype: str | None = "bfloat16",
               device: str | torch.device = "cuda") -> tuple[Callable, Callable]:
    """``(train_step, eval_step)``: ``train_step(images_u8 (B, S, S, 3), labels (B,
    num_pa), aug: AugmentParams) -> loss`` (a device scalar; afterwards each fb
    parameter's ``.grad`` holds its gradient) and ``eval_step(images_u8, labels) ->
    (loss, sigmoid scores float32)``."""
    device = module_device(fb, device)
    out_h, out_w = out_hw
    aug_dtype = augment_dtype(fb)

    def train_step(images_u8, labels, aug: AugmentParams) -> torch.Tensor:
        images = torch.as_tensor(images_u8).to(device, non_blocking=True)
        labels = torch.as_tensor(labels).to(device, non_blocking=True)
        img = anonymize(fa, augment_batch(images[:, None], aug, out_h, out_w, aug_dtype)[:, 0])
        optimizer.zero_grad(set_to_none=True)
        with autocast(device, compute_dtype):
            logits = fb(img.permute(0, 3, 1, 2), train=True)
        loss = bce_with_logits_loss(logits, labels.to(logits.dtype))
        loss.backward()
        zero_missing_grads(optimizer)
        optimizer.step()
        return loss.detach()

    def eval_step(images_u8, labels) -> tuple[torch.Tensor, torch.Tensor]:
        images = torch.as_tensor(images_u8).to(device, non_blocking=True)
        labels = torch.as_tensor(labels).to(device, non_blocking=True)
        with torch.inference_mode(), autocast(device, compute_dtype):
            img = center_crop_resize(images[:, None], 1.0, out_h, out_w, no_ar_distortion=True)[:, 0]
            logits = fb(anonymize(fa, img).permute(0, 3, 1, 2))
            return bce_with_logits_loss(logits, labels.to(logits.dtype)), torch.sigmoid(logits.float())

    return train_step, eval_step


def train_privacy(
    p: PrivacyParams,
    *,
    train_source: Any,
    val_source: Any,
    save_dir: str = "saved_models",
    fa_model: torch.nn.Module | None = None,
    fa_arch: str = "unet++",
    max_epochs: int | None = None,
    log_fn: Callable[[str], None] = print,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Stage driver (train_privacy.py:136-260). Sources give ``get_batch(indices) ->
    (images_u8 (B, S, S, 3), labels (B, num_pa))``. With ``p.anon`` every image goes
    through the frozen fa first: ``fa_model``, or ``fa_arch`` ("unet++" or "unet")
    loaded from ``p.saved_model``. The fb's initial weights come from ``p.seed``, the
    data order and the augmentation draws from ``seed``. Returns ``{"history",
    "best_cmap", "best_path", "model"}``."""
    device = resolve_device(device)
    fb = load_fb_model("r50", num_pa=p.num_pa, ssl=False, dtype="float32", seed=p.seed,
                       device=device).requires_grad_(True)
    fa = None
    if p.anon:
        fa = fa_model if fa_model is not None else load_fa_model(
            fa_arch, saved_model_file=p.saved_model, seed=p.seed, dtype=p.compute_dtype,
            device=device)
    optimizer = make_optimizer(fb.parameters(), "adam", p.learning_rate)
    train_step, eval_step = make_steps(fb, fa, optimizer, (p.reso_h, p.reso_w),
                                       compute_dtype=p.compute_dtype, device=device)

    sched = LRScheduler(p.replace(lr_scheduler="warmup_drop", learning_rate=p.learning_rate / 5))
    run_dir = os.path.join(save_dir, p.run_id)
    best = BestCheckpointer(run_dir, "model", mode="max")
    epochs = max_epochs or p.num_epochs
    history: dict[str, list] = {"train_loss": [], "val_loss": [], "cmap": [], "f1": []}
    writer = MetricsWriter(save_dir, p.run_id)

    for epoch in range(1, epochs + 1):
        try:
            t0 = time.time()
            lr = sched.epoch_lr(epoch)
            set_learning_rate(optimizer, lr)
            losses = []
            with prefetch(vispr_batches(train_source, p.batch_size, train=True, out_h=p.reso_h,
                                        out_w=p.reso_w, seed=seed + epoch)) as batch_it:
                for batch in batch_it:
                    losses.append(train_step(batch.images, batch.labels, batch.params))
            train_loss = epoch_mean(losses)
            sched.update(train_loss)
            history["train_loss"].append(train_loss)

            all_scores, all_labels, vlosses = [], [], []
            with prefetch(vispr_batches(val_source, p.v_batch_size, train=False, out_h=p.reso_h,
                                        out_w=p.reso_w, drop_last=False)) as batch_it:
                for batch in batch_it:
                    vl, scores = eval_step(batch.images, batch.labels)
                    vlosses.append(vl)
                    all_scores.append(scores.cpu().numpy())
                    all_labels.append(batch.labels)
            scores = np.concatenate(all_scores)
            labels = np.concatenate(all_labels)
            cmap, per_class = macro_average_precision(labels, scores)
            prec, rec, f1 = multilabel_prf1(labels, scores)
            history["val_loss"].append(epoch_mean(vlosses))
            history["cmap"].append(cmap)
            history["f1"].append(f1)

            variables = state_dict_to_flax(fb)
            saved = best.maybe_save(cmap, epoch, {"fb_model_state_dict": variables,
                                                  "prediction_scores": scores,
                                                  "ground_truth": labels,
                                                  "per_class_ap": per_class})
            writer.scalars({"lr": lr, "train_loss": train_loss, "cmap": cmap, "f1": f1}, epoch)
            save_temp(run_dir, "model", {"fb_model_state_dict": variables, "epoch": epoch + 1})
            log_fn(f"epoch {epoch}: lr {lr:.2e} loss {train_loss:.4f} cMAP {cmap:.4f} "
                   f"P/R/F1 {prec:.3f}/{rec:.3f}/{f1:.3f} ({time.time() - t0:.1f}s)"
                   f"{' [saved]' if saved else ''}")
        except Exception:  # noqa: BLE001 -- a bad epoch is logged and the run goes on
            log_fn(f"epoch {epoch} failed; continuing:\n{traceback.format_exc()}")
            n = max(len(v) for v in history.values())
            for v in history.values():
                v.extend([float("nan")] * (n - len(v)))

    flush_checkpoints()
    writer.close()
    return {"history": history, "best_cmap": best.best, "best_path": best.best_path, "model": fb}
