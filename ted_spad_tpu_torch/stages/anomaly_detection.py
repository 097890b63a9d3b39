"""MGFN anomaly-detection stage: weakly supervised training and frame-level AUC
evaluation (counterpart of ted_spad_tpu/stages/anomaly_detection.py; reference
anomaly_detection_mgfn/main.py, train.py, test.py).

- The optimizer is torch's Adam with coupled L2 weight decay, which is the JAX
  chain ``add_decayed_weights -> scale_by_adam -> scale(-lr)``; the LR is set per
  epoch from ``lr_schedule`` (main.py:91-93).
- A train step runs one ``[normal; abnormal]`` batch through MGFN in train mode
  (flax BatchNorm semantics, magnitude dropout from an explicit generator), the
  MGFN loss plus the smoothness and sparsity terms on the abnormal half's scores,
  backward and the Adam update (train.py:82-107).
- Evaluation buckets the test videos by length with validity masks, so a padded
  forward equals a native-length one (models/mgfn.py), and restores list order
  before the clip scores are concatenated (test.py:13-51).
- The stage computes in float32, with TF32 off around every step.
- Data parallel (``mesh``, a ``parallel.DataParallelMesh``): each rank loads and
  runs its block of both half-batches; Focus's BatchNorm takes global statistics,
  the magnitude-dropout masks are the global ones, and the step gathers the model's
  outputs in global order, so the MGFN loss pairs the global halves
  (``nor_mag[half:]`` with ``nor_mag[:half]`` over every rank's crops) and the
  smoothness term runs over the global abnormal scores; the averaged gradient is the
  one-process step's. Evaluation scores each rank's rows of a batch rounded to a
  multiple of the world size and gathers the scores, so the AUCs are the
  one-process ones.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import numpy as np
import torch

from ted_spad_tpu_torch.config.params import MGFNParams
from ted_spad_tpu_torch.data.features import (
    FeatureDataset, TestFeatureDataset, bucket_length, padded_test_batch, paired_train_batches,
)
from ted_spad_tpu_torch.data.prefetch import prefetch
from ted_spad_tpu_torch.models.mgfn import MGFN
from ted_spad_tpu_torch.ops.losses import mgfn_loss, smoothness_loss, sparsity_loss
from ted_spad_tpu_torch.ops.metrics import frame_level_scores, pr_auc, roc_auc
from ted_spad_tpu_torch.parallel.mesh import active
from ted_spad_tpu_torch.stages.common import make_optimizer as common_optimizer
from ted_spad_tpu_torch.stages.common import module_device
from ted_spad_tpu_torch.utils.device import resolve_device, tf32_off


def make_optimizer(model: MGFN, p: MGFNParams) -> torch.optim.Adam:
    """Adam, lr ``p.lr``, weight decay ``p.weight_decay`` added to the gradient
    before the moments (torch's coupled L2, main.py:72): the common ``adam`` chain
    over every parameter (LayerNorm and BatchNorm scales and biases too; the running
    statistics are buffers, not parameters)."""
    return common_optimizer(model.parameters(), "adam", p.lr, p.weight_decay)


def make_train_step(model: MGFN, optimizer: torch.optim.Optimizer, p: MGFNParams, *,
                    generator: torch.Generator | None = None,
                    device: str | torch.device = "cuda", mesh=None) -> Callable:
    """Step over one combined ``[normal; abnormal]`` batch (train.py:82-107):
    ``train_step(nfeat, nlabel, afeat, alabel) -> loss`` (a device scalar). Inputs
    may be numpy arrays or tensors: features (B, ncrops, seg_length, F+1), labels
    (B,). ``generator`` (on ``device``) draws the magnitude-dropout masks. After the
    step each parameter's ``.grad`` holds the step's gradient. With ``mesh`` the
    inputs are this rank's blocks of the global half-batches and the step is the
    one-process step over the global batch (module docstring)."""
    device = module_device(model, device)
    dtype = next(model.parameters()).dtype  # float32; float64 for a reference run

    def to_device(x) -> torch.Tensor:
        return torch.as_tensor(x).to(device, dtype, non_blocking=True)

    def gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return x if mesh is None else mesh.gather_rows(x, dim)

    def train_step(nfeat, nlabel, afeat, alabel) -> torch.Tensor:
        nfeat, nlabel, afeat, alabel = map(to_device, (nfeat, nlabel, afeat, alabel))
        batch = nfeat.shape[0]
        video = torch.cat([nfeat, afeat], dim=0)  # (2B, ncrops, T, F+1)
        optimizer.zero_grad(set_to_none=True)
        with tf32_off(), active(mesh):
            score_abnormal, score_normal, abn_fm, nor_fm, scores = model(
                video, train=True, generator=generator)
            abn_scores = scores.reshape(-1)[batch * scores.shape[1]:]  # train.py:88-91
            if mesh is not None:
                # The selected features are crop-major (ncrops * B, k, F): gather the
                # batch axis inside each crop.
                ncrops = abn_fm.shape[0] // batch
                abn_fm, nor_fm = (gather(fm.unflatten(0, (ncrops, batch)), 1).flatten(0, 1)
                                  for fm in (abn_fm, nor_fm))
                score_abnormal, score_normal, abn_scores, nlabel, alabel = map(
                    gather, (score_abnormal, score_normal, abn_scores, nlabel, alabel))
            loss = (mgfn_loss(score_normal, score_abnormal, nlabel, alabel, nor_fm, abn_fm,
                              margin=p.contrastive_margin)
                    + smoothness_loss(abn_scores, p.lambda_smooth)
                    + sparsity_loss(abn_scores, p.lambda_sparse))
            loss.backward()
            if mesh is not None:
                mesh.all_reduce_grads(model.parameters())
            optimizer.step()
        return loss.detach()

    return train_step


def make_score_fn(model: MGFN, *, device: str | torch.device = "cuda", mesh=None) -> Callable:
    """Batched scorer: video (B, ncrops, Tb, F+1) + mask (B, Tb) -> (B, Tb) float32
    crop-mean scores, a tensor on ``device``. Inputs may be numpy arrays or tensors.
    Masked bucket padding keeps results equal to per-video native-length scoring
    (models/mgfn.py), so same-bucket videos batch freely. Runs in float32 with TF32
    off during each call (utils/device.tf32_off). With ``mesh`` every rank passes the
    same global batch (B a multiple of the world size), scores its block and returns
    the gathered (B, Tb) scores."""
    device = module_device(model, device)

    def score_fn(video, mask) -> torch.Tensor:
        if mesh is not None:
            video, mask = mesh.take_rows(video), mesh.take_rows(mask)
        video = torch.as_tensor(video, dtype=torch.float32, device=device)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
        with torch.inference_mode(), tf32_off():
            *_, scores = model(video, mask)
            scores = scores[:, :, 0]
            return scores if mesh is None else mesh.gather(scores.contiguous())

    return score_fn


def evaluate(
    score_fn: Callable,
    test_ds: TestFeatureDataset,
    gt: np.ndarray,
    bucket_multiple: int = 64,
    eval_batch: int = 8,
    frames_per_clip: int = 32,
) -> tuple[float, float]:
    """Frame-level (ROC AUC, PR AUC) over the concatenated test set (test.py:13-51).

    Videos are grouped by (bucket length, ncrops) from their file headers; each
    group streams through in ``eval_batch`` chunks, a chunk padded to
    ``eval_batch`` rows by repeating its last row, while a producer thread loads the
    next chunk. List order is restored before the clip scores are concatenated and
    expanded to ``len(gt)`` frames."""
    by_bucket: dict[tuple[int, int], list[int]] = {}
    for i in range(len(test_ds)):
        shape = test_ds.peek_shape(i)
        ncrops = shape[1] if len(shape) == 3 else 1
        by_bucket.setdefault((bucket_length(shape[0], bucket_multiple), ncrops), []).append(i)

    def chunks():
        for indices in by_bucket.values():
            for s in range(0, len(indices), eval_batch):
                chunk = []
                for i in indices[s:s + eval_batch]:
                    video, mask, t = padded_test_batch(test_ds[i][0], bucket_multiple)
                    chunk.append((i, video, mask, t))
                video = np.concatenate([c[1] for c in chunk], axis=0)
                mask = np.concatenate([c[2] for c in chunk], axis=0)
                pad = eval_batch - video.shape[0]
                if pad:
                    video = np.concatenate([video, np.repeat(video[-1:], pad, axis=0)])
                    mask = np.concatenate([mask, np.repeat(mask[-1:], pad, axis=0)])
                yield [(i, t) for i, _, _, t in chunk], video, mask

    results: dict[int, np.ndarray] = {}
    with prefetch(chunks()) as chunk_it:
        for chunk, video, mask in chunk_it:
            scores = score_fn(video, mask).cpu().numpy()
            for row, (i, t) in enumerate(chunk):
                results[i] = scores[row, :t]
    clip_scores = np.concatenate([results[i] for i in range(len(test_ds))])
    pred = frame_level_scores(clip_scores, len(gt), frames_per_clip=frames_per_clip)
    return roc_auc(gt, pred), pr_auc(gt, pred)


def train_anomaly_detection(
    p: MGFNParams,
    *,
    save_dir: str = "ckpt",
    gt: np.ndarray | None = None,
    max_epochs: int | None = None,
    shuffle: bool = False,
    log_fn: Callable[[str], None] = print,
    data_root: str | None = None,
    device: str | torch.device = "cuda",
    mesh=None,
) -> dict[str, Any]:
    """The stage's training loop (main.py:30-117): train ``max_epochs`` (default
    ``p.max_epoch``) epochs, evaluate after each, keep the best checkpoint by ROC
    AUC (PR AUC for XD, main.py:107-116) and write a final one. Checkpoints hold
    ``mgfn_model_state_dict`` in the JAX package's layout, so its loaders read them.
    Returns the history, the best metric and its path, the final path and the
    trained model.

    ``mesh`` (parallel.DataParallelMesh): data parallel on ``mesh.device``, each rank
    loading its rows; a ``batch_size`` the world size does not divide disables it,
    as in the JAX package. Rank 0 alone writes the checkpoints and metrics, and every
    rank returns after they are on disk."""
    from ted_spad_tpu_torch.models import load_mgfn_model
    from ted_spad_tpu_torch.stages.common import epoch_mean, set_learning_rate
    from ted_spad_tpu_torch.utils.checkpoint import (
        BestCheckpointer, flush_checkpoints, save_checkpoint,
    )
    from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax
    from ted_spad_tpu_torch.utils.logging import MetricsWriter

    if mesh is not None and p.batch_size % mesh.world_size != 0:
        log_fn(f"mesh disabled: batch_size {p.batch_size} not divisible by "
               f"{mesh.world_size} devices")
        mesh = None
    device = resolve_device(device if mesh is None else mesh.device)
    normal_ds = FeatureDataset(p.rgb_list, p.datasetname, is_normal=True,
                               seg_length=p.seg_length, root=data_root)
    abnormal_ds = FeatureDataset(p.rgb_list, p.datasetname, is_normal=False,
                                 seg_length=p.seg_length, root=data_root)
    test_ds = TestFeatureDataset(p.test_rgb_list, p.datasetname, root=data_root)
    if gt is None:
        gt = np.load(p.gt)

    model = load_mgfn_model(p, device=device).requires_grad_(True)
    if mesh is not None:
        mesh.replicate(model)
    optimizer = make_optimizer(model, p)
    generator = torch.Generator(device=device).manual_seed(p.seed)
    train_step = make_train_step(model, optimizer, p, generator=generator, device=device,
                                 mesh=mesh)
    score_fn = make_score_fn(model, device=device, mesh=mesh)
    # An evaluation batch lands whole rows on every rank.
    eval_batch = 8 if mesh is None else max(8 // mesh.world_size, 1) * mesh.world_size

    select_pr = p.datasetname == "XD"
    best = BestCheckpointer(save_dir, p.model_name, mode="max")
    history = {"epoch": [], "test_AUC": [], "test_PR": [], "loss": []}
    writer = MetricsWriter(save_dir, p.model_name)
    try:
        for epoch in range(1, (max_epochs or p.max_epoch) + 1):
            t0 = time.time()
            if p.lr_schedule:
                set_learning_rate(optimizer, p.lr_schedule[min(epoch - 1, len(p.lr_schedule) - 1)])
            last_loss = None
            with prefetch(paired_train_batches(normal_ds, abnormal_ds, p.batch_size,
                                               shuffle=shuffle, seed=p.seed + epoch,
                                               mesh=mesh)) as batches:
                for batch in batches:
                    last_loss = train_step(*batch)  # a device scalar; read after the epoch
            auc_roc, auc_pr = evaluate(score_fn, test_ds, gt, eval_batch=eval_batch,
                                       frames_per_clip=p.frames_per_clip)
            # As in the JAX package: the epoch's loss is its last step's.
            loss_val = epoch_mean([last_loss]) if last_loss is not None else float("nan")
            history["epoch"].append(epoch)
            history["test_AUC"].append(auc_roc)
            history["test_PR"].append(auc_pr)
            history["loss"].append(loss_val)
            writer.scalars({"loss": loss_val, "roc_auc": auc_roc, "pr_auc": auc_pr}, epoch)
            metric = auc_pr if select_pr else auc_roc
            saved = None
            if best.is_better(metric):
                saved = best.maybe_save(metric, epoch,
                                        {"mgfn_model_state_dict": state_dict_to_flax(model)})
                writer.text(f"best_record_epoch_{epoch}",
                            f"epoch: {epoch}\ntest_AUC: {auc_roc}\ntest_PR: {auc_pr}\n")
            log_fn(f"epoch {epoch}: loss {loss_val:.4f} roc_auc {auc_roc:.4f} pr_auc "
                   f"{auc_pr:.4f} ({time.time() - t0:.1f}s){' [saved]' if saved else ''}")
    finally:
        writer.close()

    final_path = save_checkpoint(os.path.join(save_dir, f"{p.model_name}_final.ckpt"),
                                 {"mgfn_model_state_dict": state_dict_to_flax(model)})
    flush_checkpoints()  # the best checkpoints are on disk before they are read back
    if mesh is not None:
        mesh.barrier()  # ... on every rank's view of the disk
    return {
        "history": history,
        "best_metric": best.best,
        "best_path": best.best_path,
        "final_path": final_path,
        "model": model,
    }
