"""fa pretraining: UNet++ / UNet identity reconstruction on UCF101 frames and VISPR
images (counterpart of ted_spad_tpu/stages/fa_pretraining.py; reference
fa_pretraining/train_reconstruction.py: train_epoch :26, validation_epoch :61,
train_classifier :95).

- A train step: the host's augmentation draw applied on the card (ops/augment.py),
  the fa forward in train mode (flax BatchNorm semantics; a UNet's DoubleConvs run
  unfolded, not through kernel K2), the L1 loss (:111) against the augmented input,
  backward and Adam (lr 1e-3, no weight decay). Convolutions and matmuls run in
  ``compute_dtype`` under autocast; the parameters and the optimizer stay float32.
- Per-epoch LR: warmup, then a scheduled drop after non-improving epochs
  (``warmup_drop``, :138-161). Validation epochs are the fixed ``VAL_EPOCHS`` list
  (:133), over the whole split, centre square resized.
- Checkpoints (flax msgpack, the JAX package's layout): the best validation L1
  (``model_<epoch>_best_<l1>.ckpt``) and a rolling ``model_temp.ckpt`` holding
  ``epoch`` and ``lr_counter``; ``restart`` resumes from the temp's weights and epoch
  (:178-196). An epoch that fails is logged with its traceback and skipped.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from ted_spad_tpu_torch.config.params import ReconstructionParams
from ted_spad_tpu_torch.data.images import sample_image_augment_params
from ted_spad_tpu_torch.data.prefetch import prefetch
from ted_spad_tpu_torch.models import load_fa_model
from ted_spad_tpu_torch.ops.augment import AugmentParams, augment_batch, center_crop_resize
from ted_spad_tpu_torch.ops.losses import l1_loss
from ted_spad_tpu_torch.stages.common import (
    LRScheduler, augment_dtype, autocast, epoch_mean, make_optimizer, module_device, set_learning_rate,
    zero_missing_grads,
)
from ted_spad_tpu_torch.utils.checkpoint import (
    BestCheckpointer, flush_checkpoints, load_checkpoint, save_temp,
)
from ted_spad_tpu_torch.utils.device import resolve_device
from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables, state_dict_to_flax
from ted_spad_tpu_torch.utils.logging import MetricsWriter

# Validation epochs (train_reconstruction.py:133).
VAL_EPOCHS = [1, 3, 5, 10, 12, 15, 20, 25, 30, 35, 40, 45] + [50 + x for x in range(100)]


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    out_hw: tuple[int, int], *, compute_dtype: str | None = "bfloat16",
                    device: str | torch.device = "cuda") -> Callable:
    """``train_step(images_u8 (B, S, S, 3), aug: AugmentParams) -> loss`` (a device
    scalar): augment, fa forward in train mode, L1 to the augmented input, backward,
    optimizer step. After the step each parameter's ``.grad`` holds its gradient."""
    device = module_device(model, device)
    out_h, out_w = out_hw
    aug_dtype = augment_dtype(model)

    def train_step(images_u8, aug: AugmentParams) -> torch.Tensor:
        images = torch.as_tensor(images_u8).to(device, non_blocking=True)
        x = augment_batch(images[:, None], aug, out_h, out_w, aug_dtype)[:, 0].permute(0, 3, 1, 2)
        optimizer.zero_grad(set_to_none=True)
        with autocast(device, compute_dtype):
            recon = model(x, train=True)
        loss = l1_loss(recon, x)
        loss.backward()
        zero_missing_grads(optimizer)
        optimizer.step()
        return loss.detach()

    return train_step


def make_eval_step(model: torch.nn.Module, out_hw: tuple[int, int], *,
                   compute_dtype: str | None = "bfloat16",
                   device: str | torch.device = "cuda") -> Callable:
    """``eval_step(images_u8) -> (l1, recon, img)``: the centre square resized to
    ``out_hw`` (float32 in [0, 1], NHWC), the fa in eval mode, the L1 between them."""
    device = module_device(model, device)
    out_h, out_w = out_hw

    def eval_step(images_u8):
        images = torch.as_tensor(images_u8).to(device, non_blocking=True)
        with torch.inference_mode(), autocast(device, compute_dtype):
            img = center_crop_resize(images[:, None], 1.0, out_h, out_w, no_ar_distortion=True)[:, 0]
            recon = model(img.permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1)
            return l1_loss(recon, img), recon, img

    return eval_step


def train_reconstruction(
    p: ReconstructionParams,
    *,
    train_source: Any,
    val_source: Any | None = None,
    save_dir: str = "saved_models",
    max_epochs: int | None = None,
    restart: bool = False,
    log_fn: Callable[[str], None] = print,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Stage driver (train_reconstruction.py:95-216). Sources give ``get_batch(indices)
    -> (images_u8 (B, S, S, 3), _)`` (file-backed or synthetic). The fa's initial
    weights come from ``p.seed``, the data order and the augmentation draws from
    ``seed``. Returns ``{"history", "best_path", "model"}``."""
    device = resolve_device(device)
    model = load_fa_model(p.arch_fa, seed=p.seed, dtype="float32", device=device).requires_grad_(True)
    optimizer = make_optimizer(model.parameters(), "adam", p.learning_rate)
    run_dir = os.path.join(save_dir, p.run_id)
    start_epoch = 1
    temp = os.path.join(run_dir, "model_temp.ckpt")
    if restart and os.path.exists(temp):
        state = load_checkpoint(temp)
        load_jax_variables(model, state["fa_model_state_dict"])
        start_epoch = int(state.get("epoch", 1))
        log_fn(f"restarted from {temp} at epoch {start_epoch}")
    kw = dict(compute_dtype=p.compute_dtype, device=device)
    train_step = make_train_step(model, optimizer, (p.reso_h, p.reso_w), **kw)
    eval_step = make_eval_step(model, (p.reso_h, p.reso_w), **kw)

    sched = LRScheduler(p.replace(lr_scheduler="warmup_drop"))
    best = BestCheckpointer(run_dir, "model", mode="min")
    rng = np.random.default_rng(seed)
    epochs = max_epochs or p.num_epochs
    history: dict[str, list] = {"train_loss": [], "val_loss": []}
    src_size = train_source.get_batch([0])[0].shape[1]
    writer = MetricsWriter(save_dir, p.run_id)

    for epoch in range(start_epoch, epochs + 1):
        try:
            t0 = time.time()
            lr = sched.epoch_lr(epoch)
            set_learning_rate(optimizer, lr)
            order = rng.permutation(len(train_source))

            def batch_gen():
                # On the prefetch thread: loads and draws for batch N+1 while step N runs,
                # in the inline loop's rng order.
                for s in range(len(order) // p.batch_size):
                    idx = order[s * p.batch_size:(s + 1) * p.batch_size]
                    images, _ = train_source.get_batch(idx)
                    yield images, sample_image_augment_params(rng, len(idx), src_size, p.reso_h,
                                                              p.reso_w)

            losses = []
            with prefetch(batch_gen()) as batch_it:
                for images, aug in batch_it:
                    losses.append(train_step(images, aug))
            train_loss = epoch_mean(losses)
            sched.update(train_loss)
            history["train_loss"].append(train_loss)

            val_loss = float("nan")
            if val_source is not None and epoch in VAL_EPOCHS:
                vlosses = []
                for s in range(0, len(val_source), p.batch_size):  # the whole split
                    images, _ = val_source.get_batch(np.arange(s, min(s + p.batch_size, len(val_source))))
                    vlosses.append(eval_step(images)[0])
                val_loss = epoch_mean(vlosses)
                history["val_loss"].append(val_loss)
                best.maybe_save(val_loss, epoch, {"fa_model_state_dict": state_dict_to_flax(model),
                                                  "optimizer": None,
                                                  "lr_counter": sched.patience_count})
            save_temp(run_dir, "model", {"fa_model_state_dict": state_dict_to_flax(model),
                                         "epoch": epoch + 1, "lr_counter": sched.patience_count})
            writer.scalars({"lr": lr, "train_l1": train_loss, "val_l1": val_loss}, epoch)
            log_fn(f"epoch {epoch}: lr {lr:.2e} train_l1 {train_loss:.4f} val_l1 {val_loss:.4f} "
                   f"({time.time() - t0:.1f}s)")
        except Exception:  # noqa: BLE001 -- a bad epoch is logged and the run goes on
            log_fn(f"epoch {epoch} failed; continuing:\n{traceback.format_exc()}")
            continue

    flush_checkpoints()
    writer.close()
    return {"history": history, "best_path": best.best_path, "model": model}
