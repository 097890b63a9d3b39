"""Action (utility) model training: the ft on UCF101 clips, plain or through a frozen
anonymizer (counterpart of ted_spad_tpu/stages/action_training.py; reference
action_training/train_action.py -- train_epoch :28, val_epoch :107,
train_classifier :189 -- and train_anonymized_action.py).

- A train step: the host's augmentation draw applied on the card (ops/augment.py),
  the frozen fa per frame under ``no_grad`` when ``anonymized`` (with
  ``quirk_compat``, on the reference's scrambled view), then every view of the batch
  through ONE ft forward in train mode, so BN's batch statistics span all views as
  in JAX; cross entropy on the first view's logits (or SupCon with ``loss='con'``)
  plus the weighted temporal loss on the 128-d embeddings ('trip': triplet of
  anchor / same-frames positive / shifted negative; 'con': NT-Xent of two views);
  backward and the optimizer. Every ft family trains: I3Res50 (``largei3d``; its
  128-d MLP embeddings feed the temporal loss, FrozenBN backbone, train_action.py:
  39-41), InceptionI3d (``i3d``, its 1024-d feature, BN momentum 0.99, the logits'
  dropout), R3D-18 (``r3d_18``, 512-d) and MViTv2-S (``mvitv2``, 768-d, no BN or
  dropout); dropout draws from an explicit generator. Convolutions and matmuls run
  in ``compute_dtype`` under autocast over float32 parameters.
- Validation: modes x cropping factors x mirror, softmax averaged per video, each
  video decoded once per mode (train_action.py:330-381); ``three_crop`` adds two
  corner views; ``cropping_factor == 1`` evaluates at reso / 0.8 uncropped.
- Checkpoints (flax msgpack, the JAX package's layout): the best top-1
  (``model_<epoch>_best_<acc>.ckpt``) and a rolling ``model_temp.ckpt`` with
  ``epoch``; ``restart`` resumes from it; ``eval_only`` evaluates and returns.
- Data parallel (``mesh``, a ``parallel.DataParallelMesh``): each rank decodes and
  augments its block of a batch the world size divides; BN takes global statistics,
  dropout the global masks, and the step gathers the logits and embeddings in
  global order before the losses (SupCon and NT-Xent contrast the global rows); the
  averaged gradient is the one-process step's. Other batches run replicated.
  Validation runs whole on every rank; rank 0 writes the checkpoints.

"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import numpy as np
import torch

from ted_spad_tpu_torch.config.params import ActionParams
from ted_spad_tpu_torch.data.prefetch import prefetch
from ted_spad_tpu_torch.data.videos import ClipDataset, ValClipDataset
from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
from ted_spad_tpu_torch.ops.augment import (
    AugmentParams, augment_batch, center_crop_resize, five_crop_corners, resize_frames,
)
from ted_spad_tpu_torch.ops.losses import (
    cross_entropy_loss, l2_normalize, nt_xent_loss, supcon_loss, triplet_margin_loss,
)
from ted_spad_tpu_torch.ops.metrics import top1_accuracy
from ted_spad_tpu_torch.ops.temporal import scrambled_frame_view, unscrambled_frame_view
from ted_spad_tpu_torch.parallel.mesh import active
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


def _apply_fa_frames(fa: torch.nn.Module, video: torch.Tensor, quirk: bool = False) -> torch.Tensor:
    """The frozen fa per frame of (..., T, H, W, 3) float video, without gradients ->
    the same shape, float32. ``quirk`` (with (B, T) leading dims) reproduces the
    reference's scrambled fa input (train_anonymized_action.py:47-58): fa sees
    3-slice bundles of the (C, T) axis instead of RGB frames."""
    lead = video.shape[:-3]
    with torch.no_grad():
        if quirk and len(lead) == 2:
            frames = scrambled_frame_view(video)
        else:
            frames = video.reshape((-1,) + video.shape[-3:])
        out = fa(frames.permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1)
        if quirk and len(lead) == 2:
            return unscrambled_frame_view(out, *lead)
        return out.reshape(lead + out.shape[-3:])


def views_for(p: ActionParams) -> int:
    """Clip views per video: 3 for 'trip' (anchor, positive, negative), 2 for a
    contrastive pair ('con' loss or temporal loss), else 1."""
    if p.temporal_loss == "trip":
        return 3
    return 2 if (p.loss == "con" or p.temporal_loss == "con") else 1


def make_train_step(ft: torch.nn.Module, optimizer: torch.optim.Optimizer, p: ActionParams,
                    fa: torch.nn.Module | None = None, *,
                    generator: torch.Generator | None = None,
                    device: str | torch.device = "cuda", mesh=None) -> Callable:
    """``train_step(clips_u8 (B, V, T, H, W, 3), labels (B,), aug: AugmentParams,
    sharded=True) -> loss`` (a device scalar); ``generator`` (on ``device``) draws the
    dropout masks. After the step each parameter's ``.grad`` holds its gradient. With
    ``mesh`` a ``sharded`` step takes this rank's rows of the global batch and is the
    one-process step over it; an unsharded one takes the whole batch on every rank."""
    device = module_device(ft, device)
    # FrozenBN for the largei3d ft alone (train_action.py:39-41); the other families
    # take no such argument.
    frozen = {"frozen_bn": True} if p.arch == "largei3d" else {}
    aug_dtype = augment_dtype(ft)

    def train_step(clips_u8, labels, aug: AugmentParams, sharded: bool = True) -> torch.Tensor:
        dp = mesh if sharded else None
        clips = torch.as_tensor(clips_u8).to(device, non_blocking=True)
        labels = torch.as_tensor(labels).to(device, torch.long, non_blocking=True)
        b, v = clips.shape[:2]
        x = augment_batch(clips.reshape((b * v,) + clips.shape[2:]), aug, p.reso_h, p.reso_w,
                          aug_dtype)
        if fa is not None:
            if p.quirk_compat:
                # Views concatenated on T before the scrambled reshape (train_anonymizer.py:93).
                tv = x.reshape((b, v * x.shape[1]) + x.shape[2:])
                x = _apply_fa_frames(fa, tv, quirk=True).reshape(x.shape)
            else:
                x = _apply_fa_frames(fa, x)
        optimizer.zero_grad(set_to_none=True)
        with autocast(device, p.compute_dtype), active(dp):
            logits, emb = ft(x.permute(0, 4, 1, 2, 3), train=True, generator=generator, **frozen)
        logits, emb = logits.reshape(b, v, -1)[:, 0], emb.reshape(b, v, -1)
        if dp is not None:
            logits, emb, labels = dp.gather_rows(logits), dp.gather_rows(emb), dp.gather_rows(labels)
        if v > 1 and p.loss == "con":
            loss = supcon_loss(l2_normalize(emb[:, :2], dim=-1), labels)
        else:
            loss = cross_entropy_loss(logits, labels)
        if v > 1 and p.temporal_loss == "trip":
            loss = loss + p.temporal_loss_weight * triplet_margin_loss(
                emb[:, 0], emb[:, 1], emb[:, 2], margin=p.triplet_loss_margin)
        elif v > 1 and p.temporal_loss == "con":
            loss = loss + p.temporal_loss_weight * nt_xent_loss(emb[:, 0], emb[:, 1])
        loss.backward()
        zero_missing_grads(optimizer)
        if mesh is not None:
            mesh.all_reduce_grads(ft.parameters())
        optimizer.step()
        return loss.detach()

    return train_step


def make_eval_step(ft: torch.nn.Module, p: ActionParams, fa: torch.nn.Module | None = None,
                   three_crop: bool = False, *, device: str | torch.device = "cuda") -> Callable:
    """``eval_step(clips_u8 (B, 1, T, H, W, 3), cropping_factor, hflip) -> (B, classes)``
    float32 softmax of the centre view (at reso / 0.8 uncropped when ``cropping_factor
    == 1``, the reference's output_reso quirk, ucf101_dl.py:229-234), mirrored with
    ``hflip``, through the frozen fa when given; ``three_crop`` averages it with the
    top-left and bottom-right corners at the crop factor (ucf101_dl.py:297-320)."""
    device = module_device(ft, device)

    def one_view(view: torch.Tensor, hflip: bool) -> torch.Tensor:
        if hflip:
            view = view.flip(-2)
        if fa is not None:
            view = _apply_fa_frames(fa, view, quirk=p.quirk_compat)
        logits, _ = ft(view.permute(0, 4, 1, 2, 3))
        return torch.softmax(logits.float(), dim=-1)

    def eval_step(clips_u8, cropping_factor: float, hflip: bool) -> torch.Tensor:
        clips = torch.as_tensor(clips_u8).to(device, non_blocking=True)
        if cropping_factor == 1:
            out_h, out_w = int(p.reso_h / 0.8), int(p.reso_w / 0.8)
        else:
            out_h, out_w = p.reso_h, p.reso_w
        with torch.inference_mode(), autocast(device, p.compute_dtype):
            img = clips[:, 0].float() / 255.0
            probs = one_view(center_crop_resize(img, cropping_factor, out_h, out_w), hflip)
            if three_crop and cropping_factor < 1.0:
                h, w = img.shape[-3], img.shape[-2]
                for corner in five_crop_corners(img, int(h * cropping_factor), int(w * cropping_factor)):
                    probs = probs + one_view(resize_frames(corner, p.reso_h, p.reso_w), hflip)
                probs = probs / 3.0
            return probs

    return eval_step


def evaluate_action(eval_step: Callable, items, p: ActionParams, *,
                    decode_hw: tuple[int, int] = (0, 0)) -> float:
    """Mode x crop x mirror sweep with per-video softmax averaging -> top-1
    (train_action.py:330-381). Each video decodes once per mode; the views run from
    the decoded batch, which a producer thread decodes while the last one runs."""
    sums: dict[int, np.ndarray] = {}
    counts: dict[int, int] = {}
    labels: dict[int, int] = {}
    ds = ValClipDataset(items, p, mode=0, decode_w=decode_hw[1], decode_h=decode_hw[0])

    def scored_batches():
        for mode in range(p.num_modes):
            ds.mode = mode
            yield from ds.batches(p.v_batch_size)

    try:
        with prefetch(scored_batches()) as batch_it:
            for batch in batch_it:
                for cf in p.cropping_facs:
                    for hf in p.hflip:
                        probs = eval_step(batch.clips, float(cf), bool(hf)).cpu().numpy()
                        for k, vid in enumerate(batch.indices):
                            vid = int(vid)
                            sums[vid] = sums.get(vid, 0) + probs[k]
                            counts[vid] = counts.get(vid, 0) + 1
                            labels[vid] = int(batch.labels[k])
    finally:
        ds.close()
    vids = sorted(sums)
    mean_probs = np.stack([sums[v] / counts[v] for v in vids])
    return top1_accuracy(mean_probs, np.asarray([labels[v] for v in vids]))


def train_action(
    p: ActionParams,
    *,
    train_items,
    val_items,
    save_dir: str = "saved_models",
    fa_model: torch.nn.Module | None = None,
    max_epochs: int | None = None,
    decode_hw: tuple[int, int] = (0, 0),
    log_fn: Callable[[str], None] = print,
    seed: int = 0,
    device: str | torch.device = "cuda",
    mesh=None,
) -> dict[str, Any]:
    """Stage driver of train_action.py:189 and, with ``p.anonymized``,
    train_anonymized_action.py:204 (the fa from ``p.saved_model_fa``, or ``fa_model``).
    The ft's initial weights come from ``p.saved_model`` or ``p.seed``; the data order,
    the augmentation draws and the dropout masks from ``seed``. ``ft_dropout == 0``
    keeps the module's default rate, 0.5, as the JAX package does. Returns
    ``{"history", "best_acc", "best_path", "model"}``. ``mesh``: data parallel on
    ``mesh.device`` (module docstring); a batch shards when the world size divides it,
    else it runs replicated, as in the JAX package."""
    device = resolve_device(device if mesh is None else mesh.device)
    ft = load_ft_model(p.arch, saved_model_file=p.saved_model, num_classes=p.num_classes,
                       clip_shape=(p.num_frames, p.reso_h, p.reso_w), seed=p.seed,
                       dtype="float32", dropout_rate=p.ft_dropout if p.ft_dropout else None,
                       device=device).requires_grad_(True)
    fa = None
    if p.anonymized:
        fa = fa_model if fa_model is not None else load_fa_model(
            p.arch_fa, saved_model_file=p.saved_model_fa, seed=p.seed, dtype=p.compute_dtype,
            device=device)
    if mesh is not None:
        mesh.replicate(*(m for m in (ft, fa) if m is not None))
    optimizer = make_optimizer(ft.parameters(), p.opt_type, p.learning_rate, p.weight_decay,
                               p.momentum)
    run_dir = os.path.join(save_dir, p.run_id)
    start_epoch = 1
    temp_path = os.path.join(run_dir, "model_temp.ckpt")
    if p.restart and os.path.exists(temp_path):
        state = load_checkpoint(temp_path)
        load_jax_variables(ft, state["ft_model_state_dict"])
        start_epoch = int(state.get("epoch", 1))
        log_fn(f"restarted from {temp_path} at epoch {start_epoch}")

    eval_step = make_eval_step(ft, p, fa, three_crop=p.three_crop, device=device)
    if p.eval_only:
        acc = evaluate_action(eval_step, val_items, p, decode_hw=decode_hw)
        log_fn(f"eval_only top-1: {acc:.4f}")
        return {"history": {"train_loss": [], "val_acc": [acc]}, "best_acc": acc,
                "best_path": None, "model": ft}

    train_ds = ClipDataset(train_items, p, views=views_for(p), data_percentage=p.data_percentage,
                           decode_w=decode_hw[1], decode_h=decode_hw[0], seed=seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    train_step = make_train_step(ft, optimizer, p, fa, generator=generator, device=device,
                                 mesh=mesh)
    sched = LRScheduler(p)
    best = BestCheckpointer(run_dir, "model", mode="max")
    epochs = max_epochs or p.num_epochs
    history: dict[str, list] = {"train_loss": [], "val_acc": []}
    train_loss = float("nan")
    writer = MetricsWriter(save_dir, p.run_id)

    try:
        for epoch in range(start_epoch, epochs + 1):
            t0 = time.time()
            lr = sched.epoch_lr(epoch, train_loss)
            set_learning_rate(optimizer, lr)
            losses = []
            with prefetch(train_ds.batches(p.batch_size, seed=seed + epoch, mesh=mesh)) as batch_it:
                for batch in batch_it:
                    losses.append(train_step(batch.clips, batch.labels, batch.params,
                                             sharded=batch.sharded))
            train_loss = epoch_mean(losses)
            sched.update(train_loss)
            history["train_loss"].append(train_loss)

            acc = float("nan")
            if epoch in p.val_array or epoch == epochs:
                acc = evaluate_action(eval_step, val_items, p, decode_hw=decode_hw)
                history["val_acc"].append(acc)
                best.maybe_save(acc, epoch, {"ft_model_state_dict": state_dict_to_flax(ft)})
            save_temp(run_dir, "model", {"ft_model_state_dict": state_dict_to_flax(ft),
                                         "epoch": epoch + 1})
            writer.scalars({"lr": lr, "train_loss": train_loss, "val_acc": acc}, epoch)
            log_fn(f"epoch {epoch}: lr {lr:.2e} loss {train_loss:.4f} acc {acc:.4f} "
                   f"({time.time() - t0:.1f}s)")

    finally:
        train_ds.close()
    flush_checkpoints()
    writer.close()
    if mesh is not None:
        mesh.barrier()  # rank 0's checkpoints are on disk for every rank
    return {"history": history, "best_acc": best.best, "best_path": best.best_path, "model": ft}
