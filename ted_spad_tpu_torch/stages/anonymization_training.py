"""The adversarial anonymizer training, TeD-SPAD's core stage (counterpart of
ted_spad_tpu/stages/anonymization_training.py; reference
anonymization_training/train_anonymizer.py -- train_epoch :32, val_epoch_video :216,
train_classifier :319). Batches of VISPR pairs and of UCF101 clips (3 views: anchor,
positive, negative) alternate between two steps:

- odd batches, the fa step (:71-123): the fa in train mode over VISPR view 1, then
  view 2, then the clips -- three forwards whose BN statistics chain -- and the fb
  (NT-Xent over the two anonymized views) and ft (cross entropy, or SupCon under
  ``loss='con'``, plus the weighted triplet loss) frozen in eval mode; the gradient of
  ``-fb_loss_weight * loss_fb + ft_loss_weight * loss_ft`` flows through fb and ft to
  the fa, whose optimizer alone steps. fb and ft receive no ``.grad``.
- even batches, the fb/ft step (:134-197): the fa frozen in eval mode under
  ``no_grad`` (a plain-UNet fa runs its DoubleConvs through kernel K2 on the card),
  then fb in train mode (two forwards whose BN statistics chain) and ft in train mode
  (one batched forward over every view, BN's batch statistics, dropout from an
  explicit generator); one backward over ``loss_fb + loss_ft`` (parameter-disjoint)
  drives fb's optimizer and ft's.

Every forward runs in ``compute_dtype`` under autocast over float32 parameters.
``remat`` checkpoints activations (``models.layers.checkpoint``, exact for BN and
dropout): "on" each model forward as a whole, "blocks" each fa and I3Res50 stage on
its own (fb, and the ft families with no block boundaries -- InceptionI3d, R3D-18,
MViTv2-S -- in whole, as under JAX's block policy, which names none of their
values), "off" none, "auto" off up to 12,000,000 frame-pixels per step
and whole above. With ``accum_steps > 1`` the fa step runs its microbatches in turn:
gradients and losses are averaged, BN statistics chain through them, and NT-Xent /
SupCon contrast within each microbatch, not over the whole batch (the JAX package's
documented divergence). ``quirk_compat`` feeds the fa the reference's scrambled view
of the clips (VISPR images go through it clean, as in the reference).

Data parallel (``mesh``, a ``parallel.DataParallelMesh``): each rank loads and
augments its rows of both modalities, laid out in ``accum_steps`` microbatches
(``mesh.row_index(B, accum_steps)``), so its share of microbatch i is its block of the
global microbatch i, as the JAX package's ``x.reshape((n, B // n) + ...)`` defines
it; BN takes global statistics over each forward, the ft's dropout draws the global
masks, and the steps gather the fb projections and the ft logits and embeddings in
global order, so NT-Xent, SupCon and the triplet loss run over the global rows (of
each microbatch in the fa step); the averaged gradients are the one-process steps'.
A batch with a failed clip runs replicated; rank 0 alone writes.

The ft is any family (``arch_ft``: largei3d, i3d, r3d_18, mvitv2); its feature
(I3Res50's 128-d embedding, or the family's pooled feature) feeds the triplet loss
and SupCon. Checkpoints hold the three models in flax layout (the JAX
package's loaders read them); the optimizer states of ``model_{E}_full.ckpt`` are
torch ``state_dict``s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ted_spad_tpu_torch.config.params import AnonymizationParams
from ted_spad_tpu_torch.data.images import ImageBatch, vispr_batches
from ted_spad_tpu_torch.data.prefetch import prefetch
from ted_spad_tpu_torch.data.videos import ClipBatch, ClipDataset
from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model
from ted_spad_tpu_torch.models.layers import checkpoint
from ted_spad_tpu_torch.ops.augment import augment_batch, center_crop_resize
from ted_spad_tpu_torch.ops.losses import (
    cross_entropy_loss, l2_normalize, nt_xent_loss, supcon_loss, triplet_margin_loss,
)
from ted_spad_tpu_torch.ops.temporal import scrambled_frame_view, unscrambled_frame_view
from ted_spad_tpu_torch.parallel import multihost
from ted_spad_tpu_torch.parallel.mesh import active
from ted_spad_tpu_torch.stages.action_training import evaluate_action, make_eval_step
from ted_spad_tpu_torch.stages.common import (
    augment_dtype, autocast, epoch_mean, make_optimizer, module_device, set_learning_rate,
    zero_missing_grads,
)
from ted_spad_tpu_torch.utils.checkpoint import (
    BestCheckpointer, async_writer, flush_checkpoints, save_temp,
)
from ted_spad_tpu_torch.utils.device import resolve_device
from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax
from ted_spad_tpu_torch.utils.logging import MetricsWriter, config_dump

# "auto" checkpoints above this many frame-pixels per step (clips x views x frames +
# both VISPR views, times h x w); measured on a 16 GB TPU v5e (the JAX package's
# _resolve_remat), kept as it is.
REMAT_AUTO_PIXELS = 12_000_000


def _resolve_remat(p: AnonymizationParams, clips_shape: Sequence[int],
                   vispr_shape: Sequence[int]) -> bool | str:
    """``p.remat`` for a step of (B, V, T, h, w, C) clips and (N, h, w, C) VISPR views:
    True (whole forwards), False, or "blocks"."""
    if p.remat == "on":
        return True
    if p.remat == "off":
        return False
    if p.remat == "blocks":
        return "blocks"
    frames = clips_shape[0] * clips_shape[1] * clips_shape[2] + 2 * vispr_shape[0]
    return frames * clips_shape[-3] * clips_shape[-2] > REMAT_AUTO_PIXELS


def _anon_frames(fa: torch.nn.Module, video: torch.Tensor, train: bool,
                 remat: bool | str = False, quirk: bool = False) -> torch.Tensor:
    """The fa over every frame of (..., h, w, 3) -> the same shape, float32. ``train``
    uses and moves BN's batch statistics; ``quirk`` (clips (B, V, T, h, w, 3) only)
    feeds it the reference's scrambled view of the views concatenated on T
    (train_anonymizer.py:86-98) and reads its output back."""
    lead = video.shape[:-3]
    scramble = quirk and video.dim() == 6
    if scramble:
        b, vt = video.shape[0], video.shape[1] * video.shape[2]
        frames = scrambled_frame_view(video.reshape((b, vt) + video.shape[-3:]))
    else:
        frames = video.reshape((-1,) + video.shape[-3:])
    blocks = remat == "blocks"

    def run(x: torch.Tensor) -> torch.Tensor:
        return fa(x, train=train, remat_blocks=blocks)

    x = frames.permute(0, 3, 1, 2)
    out = (checkpoint(run, x) if remat is True else run(x)).float().permute(0, 2, 3, 1)
    if scramble:
        return unscrambled_frame_view(out, b, vt).reshape(lead + out.shape[-3:])
    return out.reshape(lead + out.shape[-3:])


def _ft_losses(ft: torch.nn.Module, anon_clips: torch.Tensor, labels: torch.Tensor,
               p: AnonymizationParams, train: bool, generator: torch.Generator | None = None,
               remat: bool | str = False, mesh=None,
               parts: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(classification + weighted triplet loss, triplet loss) of the ft over the
    anonymized (B, 3, T, h, w, 3) views in one batched forward (train_anonymizer.py:
    99-116). ``train``: BN's batch statistics and dropout from ``generator``. With
    ``mesh`` the rows are this rank's (in ``parts`` microbatches) and the losses the
    global batch's."""
    b, v = anon_clips.shape[:2]
    x = anon_clips.reshape((b * v,) + anon_clips.shape[2:]).permute(0, 4, 1, 2, 3)
    blocks = remat == "blocks"

    def run(t: torch.Tensor):
        if train:
            return ft(t, train=True, generator=generator, remat_blocks=blocks)
        return ft(t, remat_blocks=blocks)

    gens = (generator,) if train and generator is not None else ()
    logits, emb = checkpoint(run, x, generators=gens) if remat is True else run(x)
    logits, emb = logits.reshape(b, v, -1), emb.reshape(b, v, -1)
    if mesh is not None:
        logits, emb, labels = (mesh.gather_rows(t, parts=parts) for t in (logits, emb, labels))
    if p.loss == "con":
        loss_cls = supcon_loss(l2_normalize(emb[:, :2], dim=-1), labels)
    else:
        loss_cls = cross_entropy_loss(logits[:, 0], labels)
    loss_temporal = triplet_margin_loss(emb[:, 0], emb[:, 1], emb[:, 2], margin=p.triplet_loss_margin)
    return loss_cls + p.temporal_loss_weight * loss_temporal, loss_temporal


def _fb_loss(fb: torch.nn.Module, anon_pair: tuple[torch.Tensor, torch.Tensor],
             p: AnonymizationParams, train: bool, remat: bool | str = False, mesh=None,
             parts: int = 1) -> torch.Tensor:
    """NT-Xent over the fb projections of the two anonymized VISPR views, (N, h, w, 3)
    each (train_anonymizer.py:78-84): two forwards, whose BN statistics chain in train
    mode; under any remat each is checkpointed whole, as in the JAX package. With
    ``mesh`` the projections are gathered and the loss contrasts the global rows."""
    def run(x: torch.Tensor) -> torch.Tensor:
        return fb(x.permute(0, 3, 1, 2), train=train)

    z1, z2 = ((checkpoint(run, x) if remat else run(x)) for x in anon_pair)
    if mesh is not None:
        z1, z2 = mesh.gather_rows(z1, parts=parts), mesh.gather_rows(z2, parts=parts)
    return nt_xent_loss(z1, z2, p.nt_xent_temperature, p.nt_xent_cosine)


@contextlib.contextmanager
def _frozen(*models: torch.nn.Module):
    """``requires_grad`` off on the models' parameters inside the block, restored on
    exit: autograd then keeps only what the gradient to the other inputs needs."""
    params = [q for m in models for q in m.parameters()]
    flags = [q.requires_grad for q in params]
    for q in params:
        q.requires_grad_(False)
    try:
        yield
    finally:
        for q, flag in zip(params, flags):
            q.requires_grad_(flag)


def make_fa_step(fa: torch.nn.Module, fb: torch.nn.Module, ft: torch.nn.Module,
                 opt_fa: torch.optim.Optimizer, p: AnonymizationParams, *,
                 device: str | torch.device = "cuda", mesh=None) -> Callable:
    """``fa_step(vispr1, vispr2, clips, labels, sharded=True) -> (loss_fa, loss_fb,
    loss_ft, loss_temporal)`` (a device tensor) on augmented inputs: VISPR views (N,
    h, w, 3), clips (B, 3, T, h, w, 3), labels (B,). Afterwards each fa parameter's
    ``.grad`` holds its gradient (the microbatches' mean under ``p.accum_steps``); fb
    and ft are left without one. With ``mesh`` a ``sharded`` step takes this rank's
    rows in ``p.accum_steps`` microbatches (module docstring) and is the one-process
    step over the global batch; an unsharded one takes the whole batch on every
    rank."""
    device = module_device(fa, device)
    params = list(fa.parameters())
    n = p.accum_steps

    def one(v1, v2, clips, labels, remat, dp):
        with active(dp):  # also over the backward: remat recomputes BN there
            with autocast(device, p.compute_dtype):
                a1 = _anon_frames(fa, v1[:, None], True, remat)
                a2 = _anon_frames(fa, v2[:, None], True, remat)
                loss_fb = _fb_loss(fb, (a1[:, 0], a2[:, 0]), p, False, remat, mesh=dp)
                anon_clips = _anon_frames(fa, clips, True, remat, quirk=p.quirk_compat)
                loss_ft, loss_temporal = _ft_losses(ft, anon_clips, labels, p, False,
                                                    remat=remat, mesh=dp)
                loss_fa = -p.fb_loss_weight * loss_fb + p.ft_loss_weight * loss_ft
            grads = torch.autograd.grad(loss_fa, params, allow_unused=True)
        losses = torch.stack([loss_fa, loss_fb, loss_ft, loss_temporal]).detach()
        return [torch.zeros_like(q) if g is None else g for q, g in zip(params, grads)], losses

    def fa_step(vispr1, vispr2, clips, labels, sharded: bool = True) -> torch.Tensor:
        dp = mesh if sharded else None
        labels = torch.as_tensor(labels).to(device, torch.long)
        opt_fa.zero_grad(set_to_none=True)
        mv, mb = vispr1.shape[0] // n, clips.shape[0] // n
        remat = _resolve_remat(p, clips[:mb].shape, vispr1[:mv].shape)
        grads, losses = [torch.zeros_like(q) for q in params], 0.0
        with _frozen(fb, ft):
            for i in range(n):  # n == 1: the whole batch, grads and losses exact
                v, c = slice(i * mv, (i + 1) * mv), slice(i * mb, (i + 1) * mb)
                g, l = one(vispr1[v], vispr2[v], clips[c], labels[c], remat, dp)
                grads = [a + gi / n for a, gi in zip(grads, g)]
                losses = losses + l / n
        for q, g in zip(params, grads):
            q.grad = g
        if mesh is not None:
            mesh.all_reduce_grads(params)
        opt_fa.step()
        return losses

    return fa_step


def make_fbft_step(fa: torch.nn.Module, fb: torch.nn.Module, ft: torch.nn.Module,
                   opt_fb: torch.optim.Optimizer, opt_ft: torch.optim.Optimizer,
                   p: AnonymizationParams, *, generator: torch.Generator | None = None,
                   device: str | torch.device = "cuda", mesh=None) -> Callable:
    """``fbft_step(vispr1, vispr2, clips, labels, sharded=True) -> (loss_fb, loss_ft,
    loss_temporal)`` (a device tensor) on augmented inputs (as ``make_fa_step``'s,
    ``mesh`` and ``sharded`` too); ``generator`` (on ``device``) draws the ft's dropout
    masks. Afterwards each fb and ft parameter's ``.grad`` holds its gradient."""
    device = module_device(fa, device)
    parts = p.accum_steps  # the rows' layout under a mesh (the fa step's microbatches)

    def fbft_step(vispr1, vispr2, clips, labels, sharded: bool = True) -> torch.Tensor:
        dp = mesh if sharded else None
        labels = torch.as_tensor(labels).to(device, torch.long)
        remat = _resolve_remat(p, clips.shape, vispr1.shape)
        with torch.no_grad(), autocast(device, p.compute_dtype):
            a1 = _anon_frames(fa, vispr1[:, None], False)
            a2 = _anon_frames(fa, vispr2[:, None], False)
            anon_clips = _anon_frames(fa, clips, False, quirk=p.quirk_compat)
        opt_fb.zero_grad(set_to_none=True)
        opt_ft.zero_grad(set_to_none=True)
        with active(dp, parts):  # also over the backward: remat recomputes BN there
            with autocast(device, p.compute_dtype):
                loss_fb = _fb_loss(fb, (a1[:, 0], a2[:, 0]), p, True, remat, dp, parts)
                loss_ft, loss_temporal = _ft_losses(ft, anon_clips, labels, p, True, generator,
                                                    remat, dp, parts)
            (loss_fb + loss_ft).backward()
        for opt, model in ((opt_fb, fb), (opt_ft, ft)):
            zero_missing_grads(opt)
            if mesh is not None:
                mesh.all_reduce_grads(model.parameters())
            opt.step()
        return torch.stack([loss_fb, loss_ft, loss_temporal]).detach()

    return fbft_step


def augment_inputs(vispr_b: ImageBatch, video_b: ClipBatch, p: AnonymizationParams,
                   device: torch.device, dtype: torch.dtype = torch.float32):
    """A VISPR pair batch and a clip batch, augmented on ``device`` in ``dtype``:
    (vispr1 (N, h, w, 3), vispr2, clips (B, V, T, h, w, 3), labels (B,))."""
    images = torch.as_tensor(vispr_b.images).to(device, non_blocking=True)[:, None]
    v1 = augment_batch(images, vispr_b.params, p.reso_h, p.reso_w, dtype)[:, 0]
    v2 = augment_batch(images, vispr_b.params2, p.reso_h, p.reso_w, dtype)[:, 0]
    raw = torch.as_tensor(video_b.clips).to(device, non_blocking=True)
    b, v = raw.shape[:2]
    clips = augment_batch(raw.reshape((b * v,) + raw.shape[2:]), video_b.params, p.reso_h,
                          p.reso_w, dtype)
    labels = torch.as_tensor(video_b.labels).to(device, torch.long)
    return v1, v2, clips.reshape((b, v) + clips.shape[1:]), labels


def _paired(vispr_it, video_it, mesh, batch_size_vispr: int, parts: int):
    """The VISPR and clip batches of a step, side by side. Under a mesh a clip batch
    that runs replicated (a failed decode) gets the whole VISPR batch too: the ranks
    swap their rows here, on the producer thread, which alone uses the host group
    while the epoch runs."""
    for vispr_b, video_b in zip(vispr_it, video_it):
        if mesh is not None and not video_b.sharded:
            vispr_b = mesh.unshard_rows(vispr_b, batch_size_vispr, parts)
        yield vispr_b, video_b


def _optimizer_tree(opt: torch.optim.Optimizer) -> dict:
    """An optimizer's ``state_dict`` with string keys (flax msgpack maps need them)."""
    sd = opt.state_dict()
    return {"state": {str(k): v for k, v in sd["state"].items()}, "param_groups": sd["param_groups"]}


def save_vispr_visualization(fa: torch.nn.Module, images_u8: np.ndarray, out_path: str,
                             reso: tuple[int, int]) -> str:
    """The anonymization preview: the centre-cropped originals in a row over their
    anonymized copies, clipped to [0, 1], as one PNG (val_visualization_fa_vispr,
    train_anonymizer.py:305-315)."""
    from PIL import Image

    device = next(fa.parameters()).device
    images = torch.as_tensor(images_u8).to(device)
    with torch.inference_mode():
        img = center_crop_resize(images[:, None], 1.0, reso[0], reso[1], no_ar_distortion=True)[:, 0]
        anon = fa(img.permute(0, 3, 1, 2).to(next(fa.parameters()).dtype)).float()
        anon = anon.clamp(0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy()
    orig = img.float().cpu().numpy()
    grid = np.concatenate([np.concatenate(list(orig), axis=1), np.concatenate(list(anon), axis=1)], axis=0)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    Image.fromarray((grid * 255 + 0.5).astype(np.uint8)).save(out_path)
    return out_path


def train_anonymizer(
    p: AnonymizationParams,
    *,
    train_items,
    val_items,
    vispr_source,
    save_dir: str = "saved_models",
    max_epochs: int | None = None,
    decode_hw: tuple[int, int] = (0, 0),
    log_fn: Callable[[str], None] = print,
    seed: int = 0,
    device: str | torch.device = "cuda",
    mesh=None,
) -> dict[str, Any]:
    """Stage driver (train_anonymizer.py:319-555). The three models' initial weights
    come from ``p.saved_model_{fa,fb,ft}`` or ``p.seed``; the data order, the
    augmentation draws and the dropout masks from ``seed``. Returns ``{"history",
    "best_acc", "best_path", "fa", "fb", "ft"}``. ``mesh``: data parallel on
    ``mesh.device`` (module docstring) when the world size divides both batch sizes,
    the JAX package's condition, taken per microbatch: with ``accum_steps`` n the world
    size times n must divide them, since each rank holds an equal block of each
    microbatch (JAX would split a microbatch unevenly); else the mesh is disabled and
    every rank runs the one-process step."""
    parts = p.accum_steps
    if mesh is not None and not (mesh.divides(p.batch_size, parts)
                                 and mesh.divides(p.batch_size_vispr, parts)):
        log_fn(f"mesh disabled: batch sizes {p.batch_size} / {p.batch_size_vispr} not "
               f"divisible by {mesh.world_size} devices x {parts} microbatches")
        mesh = None
    device = resolve_device(device if mesh is None else mesh.device)
    fa = load_fa_model(p.arch_fa, saved_model_file=p.saved_model_fa, seed=p.seed, dtype="float32",
                       device=device).requires_grad_(True)
    ft = load_ft_model(p.arch_ft, saved_model_file=p.saved_model_ft, num_classes=p.num_classes,
                       clip_shape=(p.num_frames, p.reso_h, p.reso_w), seed=p.seed, dtype="float32",
                       device=device).requires_grad_(True)
    fb = load_fb_model(p.arch_fb, p.saved_model_fb, num_pa=p.num_pa, ssl=True, dtype="float32",
                       seed=p.seed, device=device).requires_grad_(True)

    # Three optimizers with scaled LRs (train_anonymizer.py:377-388; params :55-57).
    opt_fa = make_optimizer(fa.parameters(), p.opt_type, p.learning_rate_fa, p.weight_decay)
    opt_fb = make_optimizer(fb.parameters(), p.opt_type, p.learning_rate_fb, p.weight_decay)
    opt_ft = make_optimizer(ft.parameters(), p.opt_type, p.learning_rate_ft, p.weight_decay)
    if mesh is not None:
        mesh.replicate(fa, fb, ft)
    generator = torch.Generator(device=device).manual_seed(seed)
    fa_step = make_fa_step(fa, fb, ft, opt_fa, p, device=device, mesh=mesh)
    fbft_step = make_fbft_step(fa, fb, ft, opt_fb, opt_ft, p, generator=generator, device=device,
                               mesh=mesh)
    ft_eval = make_eval_step(ft, p, fa=fa, device=device)

    video_ds = ClipDataset(train_items, p, views=3, data_percentage=p.data_percentage,
                           decode_w=decode_hw[1], decode_h=decode_hw[0], seed=seed)
    run_dir = os.path.join(save_dir, p.run_id)
    best = BestCheckpointer(run_dir, "model", mode="max", threshold=p.save_acc_threshold)
    epochs = max_epochs or p.num_epochs
    history: dict[str, list] = {"loss_fa": [], "loss_fb": [], "loss_ft": [], "loss_temporal": [],
                                "val_acc": []}
    writer = MetricsWriter(save_dir, p.run_id)
    config_dump(writer, p)
    aug_dtype = augment_dtype(fa)

    try:
        for epoch in range(1, epochs + 1):
            t0 = time.time()
            # Constant LRs unless use_lr_schedule (train_anonymizer.py:432-450).
            scale = 1.0
            if p.use_lr_schedule:
                arr = p.cosine_lr_array
                scale = arr[min(epoch - 1, len(arr) - 1)]
            set_learning_rate(opt_fa, scale * p.learning_rate_fa)
            set_learning_rate(opt_fb, scale * p.learning_rate_fb)
            set_learning_rate(opt_ft, scale * p.learning_rate_ft)

            vispr_it = vispr_batches(vispr_source, p.batch_size_vispr, train=True, ssl=True,
                                     out_h=p.reso_h, out_w=p.reso_w, seed=seed + epoch,
                                     mesh=mesh, parts=parts)
            video_it = video_ds.batches(p.batch_size, seed=seed + epoch, mesh=mesh, parts=parts)
            fa_turn = True
            fa_losses, fbft_losses = [], []
            with prefetch(_paired(vispr_it, video_it, mesh, p.batch_size_vispr, parts)) as paired_it:
                for vispr_b, video_b in paired_it:
                    sharded = video_b.sharded
                    v1, v2, clips, labels = augment_inputs(vispr_b, video_b, p, device, aug_dtype)
                    if fa_turn:
                        if p.accum_steps > 1:
                            # A ragged batch (a corrupt video dropped, the min-2 collate
                            # filter) is trimmed to a multiple of the microbatches; the
                            # pair is skipped when fewer samples than microbatches survive.
                            na = p.accum_steps
                            bm = (clips.shape[0] // na) * na
                            vm = (min(v1.shape[0], v2.shape[0]) // na) * na
                            if bm == 0 or vm == 0:
                                continue
                            v1, v2, clips, labels = v1[:vm], v2[:vm], clips[:bm], labels[:bm]
                        fa_losses.append(fa_step(v1, v2, clips, labels, sharded))
                    else:
                        fbft_losses.append(fbft_step(v1, v2, clips, labels, sharded))
                    fa_turn = not fa_turn
            history["loss_fa"].append(epoch_mean([x[0] for x in fa_losses]))
            for col, k in enumerate(("loss_fb", "loss_ft", "loss_temporal")):
                history[k].append(epoch_mean([x[col] for x in fbft_losses]))

            models = {"fa_model_state_dict": state_dict_to_flax(fa),
                      "fb_model_state_dict": state_dict_to_flax(fb),
                      "ft_model_state_dict": state_dict_to_flax(ft)}
            acc = float("nan")
            if epoch in p.val_array or epoch == epochs:
                if multihost.is_writer():
                    vis_imgs, _ = vispr_source.get_batch(list(range(min(4, len(vispr_source)))))
                    save_vispr_visualization(fa, vis_imgs,
                                             os.path.join(run_dir, "visuals", f"epoch_{epoch}.png"),
                                             (p.reso_h, p.reso_w))
                acc = evaluate_action(ft_eval, val_items, p, decode_hw=decode_hw)
                history["val_acc"].append(acc)
                best.maybe_save(acc, epoch, models)
            payload = {**models, "epoch": epoch + 1}
            save_temp(run_dir, "model", payload)
            if epoch % 3 == 0:  # the optimizer states every 3rd epoch (train_anonymizer.py:539-550)
                async_writer().save(os.path.join(run_dir, f"model_{epoch}_full.ckpt"), {
                    **payload, **{f"opt_{k}": _optimizer_tree(o)
                                  for k, o in (("fa", opt_fa), ("fb", opt_fb), ("ft", opt_ft))}})
            writer.scalars({"lr_fa": scale * p.learning_rate_fa, "loss_fa": history["loss_fa"][-1],
                            "loss_fb": history["loss_fb"][-1], "loss_ft": history["loss_ft"][-1],
                            "loss_temporal": history["loss_temporal"][-1], "val_acc": acc}, epoch)
            log_fn(f"epoch {epoch}: fa {history['loss_fa'][-1]:.4f} fb {history['loss_fb'][-1]:.4f} "
                   f"ft {history['loss_ft'][-1]:.4f} acc {acc:.4f} ({time.time() - t0:.1f}s)")
    finally:
        video_ds.close()
    flush_checkpoints()
    writer.close()
    if mesh is not None:
        mesh.barrier()  # rank 0's checkpoints are on disk for every rank
    return {"history": history, "best_acc": best.best, "best_path": best.best_path,
            "fa": fa, "fb": fb, "ft": ft}
