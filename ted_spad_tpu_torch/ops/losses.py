"""MGFN losses on tensors (counterpart of the MGFN part of ted_spad_tpu/ops/losses.py;
reference anomaly_detection_mgfn/train.py). Reductions run in float32 (float64 inputs
stay float64)."""

from __future__ import annotations

import torch

from ted_spad_tpu_torch.utils.device import at_least_f32


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
