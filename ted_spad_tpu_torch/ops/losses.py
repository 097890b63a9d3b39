"""Losses on tensors (counterpart of ted_spad_tpu/ops/losses.py): the training stages'
losses (L1, cross entropy, BCE with logits, the temporal triplet loss, NT-Xent,
SupCon) and MGFN's (reference anomaly_detection_mgfn/train.py). Reductions run in
float32 (float64 inputs stay float64)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ted_spad_tpu_torch.utils.device import at_least_f32


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize(p=2)``: divide by max(norm, eps)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels (train_anonymizer.py:347)."""
    logp = F.log_softmax(at_least_f32(logits), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def bce_with_logits_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE over all elements (train_privacy.py:157):
    max(x, 0) - x t + log(1 + exp(-|x|))."""
    x, t = at_least_f32(logits), at_least_f32(targets)
    return torch.mean(torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs())))


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (train_reconstruction.py:111)."""
    return torch.mean(torch.abs(at_least_f32(pred) - at_least_f32(target)))


def bce_loss(probs: torch.Tensor, targets: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """BCE on probabilities (MGFN scores are already sigmoid'd; train.py:52, 66)."""
    p = at_least_f32(probs).clamp(eps, 1.0 - eps)
    t = at_least_f32(targets)
    return torch.mean(-(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)))


def _pairwise_distance(x: torch.Tensor, y: torch.Tensor, p: float = 2.0,
                       eps: float = 1e-6) -> torch.Tensor:
    """Row-wise Lp distance as torch's ``F.pairwise_distance``: eps is added to the
    difference."""
    d = at_least_f32(x) - at_least_f32(y) + eps
    return torch.sum(torch.abs(d) ** p, dim=-1) ** (1.0 / p)


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                        margin: float = 1.0, p: float = 2.0) -> torch.Tensor:
    """torch ``nn.TripletMarginLoss`` (train_anonymizer.py:349-350) on the 128-d
    embeddings of (anchor, same-frames positive, temporally shifted negative)."""
    d_ap = _pairwise_distance(anchor, positive, p)
    d_an = _pairwise_distance(anchor, negative, p)
    return torch.mean(torch.clamp(d_ap - d_an + margin, min=0.0))


def nt_xent_loss(zis: torch.Tensor, zjs: torch.Tensor, temperature: float = 0.1,
                 use_cosine_similarity: bool = False) -> torch.Tensor:
    """SimCLR NT-Xent (aux_code/nt_xent_original.py:49-70): representations [zjs; zis],
    positives on the +-B diagonals, the other 2B - 2 entries of a row negatives; the
    cross entropy over [positive | negatives] / temperature, averaged over 2B rows.
    The negatives are the full row with the self and positive entries at -inf, as
    the JAX package's static masks."""
    b = zis.shape[0]
    reps = at_least_f32(torch.cat([zjs, zis], dim=0))
    if use_cosine_similarity:
        reps = l2_normalize(reps, dim=-1)
    sim = reps @ reps.T
    positives = torch.cat([torch.diagonal(sim, b), torch.diagonal(sim, -b)])[:, None]
    eye = torch.eye(2 * b, dtype=torch.bool, device=sim.device)
    negatives = sim.masked_fill(eye | eye.roll(b, dims=1), float("-inf"))  # self, positives
    logits = torch.cat([positives, negatives], dim=1) / temperature
    return -F.log_softmax(logits, dim=-1)[:, 0].mean()


def supcon_loss(features: torch.Tensor, labels: torch.Tensor, temperature: float = 0.07,
                base_temperature: float = 0.07) -> torch.Tensor:
    """Supervised contrastive loss (Khosla et al. 2020, 'all' contrast mode) over
    (B, V, D) L2-normalized views with integer labels: ``loss='con'``
    (train_action.py:60-65)."""
    b, v, _ = features.shape
    feats = at_least_f32(features).reshape(b * v, -1)
    labels = labels.reshape(-1).repeat_interleave(v)
    sim = feats @ feats.T / temperature
    sim = sim - sim.max(dim=1, keepdim=True).values.detach()
    not_self = ~torch.eye(b * v, dtype=torch.bool, device=sim.device)
    pos = (labels[:, None] == labels[None, :]) & not_self
    log_prob = sim - torch.log(torch.sum(torch.exp(sim) * not_self, dim=1, keepdim=True) + 1e-12)
    mean_log_prob_pos = torch.sum(pos * log_prob, dim=1) / torch.clamp(pos.sum(dim=1), min=1)
    return torch.mean(-(temperature / base_temperature) * mean_log_prob_pos)


def sparsity_loss(scores: torch.Tensor, lam: float = 8e-3) -> torch.Tensor:
    """L2 norm of the abnormal snippet scores (train.py:8-10)."""
    return lam * torch.linalg.vector_norm(at_least_f32(scores).reshape(-1))


def smoothness_loss(scores: torch.Tensor, lam: float = 8e-4) -> torch.Tensor:
    """Sum of squared successive differences, the last score repeated (train.py:13-20)."""
    s = at_least_f32(scores).reshape(-1)
    shifted = torch.cat([s[1:], s[-1:]])
    return lam * torch.sum((shifted - s) ** 2)


def magnitude_contrastive_loss(out1: torch.Tensor, out2: torch.Tensor, label: float,
                               margin: float = 200.0) -> torch.Tensor:
    """Feature-magnitude contrastive loss (train.py:23-32): ``label=1`` pushes the two
    magnitude sets at least ``margin`` apart, ``label=0`` pulls them together."""
    d = _pairwise_distance(out1, out2)
    return torch.mean((1.0 - label) * d ** 2 + label * torch.clamp(margin - d, min=0.0) ** 2)


def mgfn_loss(
    score_normal: torch.Tensor,
    score_abnormal: torch.Tensor,
    nlabel: torch.Tensor,
    alabel: torch.Tensor,
    nor_feamagnitude: torch.Tensor,
    abn_feamagnitude: torch.Tensor,
    margin: float = 200.0,
) -> torch.Tensor:
    """Composite MGFN loss (train.py:47-75): ``cls + (0.001*separate + cluster_a +
    cluster_n) * 0.001``. ``score_*``: (B, 1) top-k mean scores; ``*_feamagnitude``:
    (ncrops*B, k, F) selected snippet features, each set split at its own half."""
    label = at_least_f32(torch.cat([nlabel, alabel], dim=0))
    score = torch.cat([score_normal, score_abnormal], dim=0).reshape(-1)
    loss_cls = bce_loss(score, label)

    abn_mag = torch.linalg.vector_norm(at_least_f32(abn_feamagnitude), ord=1, dim=2)  # (N, k)
    nor_mag = torch.linalg.vector_norm(at_least_f32(nor_feamagnitude), ord=1, dim=2)
    half = abn_mag.shape[0] // 2
    loss_con = magnitude_contrastive_loss(abn_mag, nor_mag, 1.0, margin)
    loss_con_n = magnitude_contrastive_loss(nor_mag[half:], nor_mag[:half], 0.0, margin)
    loss_con_a = magnitude_contrastive_loss(abn_mag[half:], abn_mag[:half], 0.0, margin)
    return loss_cls + (0.001 * loss_con + loss_con_a + loss_con_n) * 0.001
