"""Plain float32 reference of TeD-SPAD's adversarial training steps (the paper's
section 3.3; the reference implementation's ``train_anonymizer.py``), over dicts of
parameters and running statistics.

- The fa step: the anonymizer fa in train mode over VISPR view 1, view 2, then the
  clips (three forwards; each moves fa's BatchNorm running statistics, flax's rule
  ``ra = 0.9 ra + 0.1 batch statistic`` with the biased variance); the privacy model
  fb (ResNet-50 + projection head) in eval mode gives NT-Xent over the two views; the
  action model ft (I3Res50 + classifier + 128-d MLP head) in eval mode gives cross
  entropy on the anchor views plus 0.1 x the triplet loss (anchor, positive,
  negative); fa's loss ``-1.0 * fb's + 0.7 * ft's`` steps fa's Adam alone.
- The fb/ft step: fa in eval mode without gradient; fb in train mode over the two
  views (two forwards), ft in train mode over every view in one forward, dropout 0.5
  before the classifier from the mask the step is given; one backward over the sum
  drives fb's and ft's Adam.

Adam is torch's, with the L2 weight decay added to the gradient (the optax chain of
the reference's ``add_decayed_weights -> scale_by_adam``). Activations are
checkpointed stage by stage (``checkpointing``), which changes no value; a recompute
keeps the running statistics its first pass recorded. ``Prec`` rounds every conv and
matmul operand for the control. Nothing here imports the program or JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_port.reference.augment import augment
from bench_port.reference.models import (
    F32, Prec, bn, i3res50_features, linear, plain_call, resnet2d, unetpp,
)

BN_MOMENTUM = 0.9
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def nt_xent(zi, zj, temperature: float):
    """SimCLR's NT-Xent over [zj; zi]: each row's positive is its other view, its
    negatives every other row but itself; cross entropy over [positive | negatives]."""
    b = zi.shape[0]
    reps = torch.cat([zj, zi])
    sim = reps @ reps.t() / temperature
    idx = torch.arange(2 * b, device=sim.device)
    pos = sim[idx, (idx + b) % (2 * b)]
    sim = sim.masked_fill(torch.eye(2 * b, dtype=torch.bool, device=sim.device), float("-inf"))
    return (torch.logsumexp(sim, dim=1) - pos).mean()


def move_running(P: dict, stats: dict) -> None:
    with torch.no_grad():
        for name, (mean, var) in stats.items():
            P[name + ".running_mean"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            P[name + ".running_var"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)


class AdversarialReference:
    """The three models' state and optimizers, stepped as the stage steps them."""

    def __init__(self, weights: dict, cfg: dict, q: Prec = F32, checkpointing: bool = True):
        self.cfg, self.q, self.an = cfg, q, cfg["anonymization"]
        self.ck = ckpt if checkpointing else plain_call
        self.P = {m: {k: v.detach().float().clone() for k, v in w.items()}
                  for m, w in weights.items()}
        self.names = {m: [k for k in P if k.rsplit(".", 1)[-1] not in BUFFERS]
                      for m, P in self.P.items()}
        lr = self.an["learning_rate"]
        self.opt = {}
        for m, scale in (("fa", self.an["fa_lr_scale"]), ("fb", self.an["fb_lr_scale"]),
                         ("ft", self.an["ft_lr_scale"])):
            leaves = [self.P[m][k].requires_grad_(True) for k in self.names[m]]
            self.opt[m] = torch.optim.Adam(leaves, lr=scale * lr, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=self.an["weight_decay"])

    # --- models ---------------------------------------------------------------------

    def fa(self, frames, train: bool):
        """(N, 3, h, w) -> (N, 3, h, w); in train mode the running statistics move."""
        stats = {} if train else None
        out = unetpp(frames, self.P["fa"], self.cfg["fa"], self.q, stats,
                     self.ck if train else plain_call)
        if train:
            move_running(self.P["fa"], stats)
        return out

    def fb(self, images, train: bool):
        stats = {} if train else None
        P, fb_cfg = self.P["fb"], self.cfg["fb"]
        feats = resnet2d(images, P, "backbone.", fb_cfg["layers"], True, self.q, stats, self.ck)
        h = feats[-1].mean(dim=(2, 3))
        z = linear(F.relu(linear(h, P, "proj_fc1", self.q)), P, "proj_fc2", self.q)
        if train:
            move_running(P, stats)
        return F.normalize(z, dim=-1)

    def ft(self, clips, train: bool, mask=None):
        """(B, 3, T, h, w) -> (logits, 128-d unit embedding)."""
        stats = {} if train else None
        P = self.P["ft"]
        feat = i3res50_features(clips, P, self.cfg["ft"], self.q, stats, "i3d.", self.ck)
        logits = linear(feat * mask if mask is not None else feat, P, "i3d.fc", self.q)
        e = F.relu(bn(linear(feat, P, "mlp.fc1", self.q), P, "mlp.bn1", stats))
        e = bn(linear(e, P, "mlp.fc2", self.q), P, "mlp.bn2", stats)
        if train:
            move_running(P, stats)
        return logits, F.normalize(e, dim=-1)

    # --- the steps ------------------------------------------------------------------

    def anonymize(self, v1, v2, clips, train: bool):
        """The fa over both VISPR views (N, h, w, 3) and the clips (B, V, T, h, w, 3):
        (a1, a2) as (N, 3, h, w) and the clips as (B * V, 3, T, h, w)."""
        a1 = self.fa(v1.permute(0, 3, 1, 2), train)
        a2 = self.fa(v2.permute(0, 3, 1, 2), train)
        b, v, t = clips.shape[:3]
        frames = clips.reshape((b * v * t,) + clips.shape[3:]).permute(0, 3, 1, 2)
        anon = self.fa(frames, train)
        return a1, a2, anon.reshape((b * v, t) + anon.shape[1:]).transpose(1, 2)

    def ft_loss(self, clips, labels, train: bool, mask=None):
        logits, emb = self.ft(clips, train, mask)
        b = labels.shape[0]
        logits, emb = logits.reshape(b, 3, -1), emb.reshape(b, 3, -1)
        trip = F.triplet_margin_loss(emb[:, 0], emb[:, 1], emb[:, 2],
                                     margin=self.an["triplet_loss_margin"])
        return F.cross_entropy(logits[:, 0], labels) + self.an["temporal_loss_weight"] * trip, trip

    def fa_step(self, v1, v2, clips, labels) -> torch.Tensor:
        """(loss_fa, loss_fb, loss_ft, loss_temporal)."""
        an = self.an
        a1, a2, anon = self.anonymize(v1, v2, clips, True)
        loss_fb = nt_xent(self.fb(a1, False), self.fb(a2, False), an["nt_xent_temperature"])
        loss_ft, trip = self.ft_loss(anon, labels, False)
        loss_fa = -an["fb_loss_weight"] * loss_fb + an["ft_loss_weight"] * loss_ft
        leaves = self.opt["fa"].param_groups[0]["params"]
        grads = torch.autograd.grad(loss_fa, leaves, allow_unused=True)
        for p, g in zip(leaves, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        self.opt["fa"].step()
        self.opt["fa"].zero_grad(set_to_none=True)
        return torch.stack([loss_fa, loss_fb, loss_ft, trip]).detach()

    def fbft_step(self, v1, v2, clips, labels, mask) -> torch.Tensor:
        """(loss_fb, loss_ft, loss_temporal); ``mask`` the dropout mask (B * V, F)."""
        with torch.no_grad():
            a1, a2, anon = self.anonymize(v1, v2, clips, False)
        loss_fb = nt_xent(self.fb(a1, True), self.fb(a2, True), self.an["nt_xent_temperature"])
        loss_ft, trip = self.ft_loss(anon, labels, True, mask)
        (loss_fb + loss_ft).backward()
        for m in ("fb", "ft"):
            for p in self.opt[m].param_groups[0]["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.opt[m].step()
            self.opt[m].zero_grad(set_to_none=True)
        return torch.stack([loss_fb, loss_ft, trip]).detach()


def augmented(vispr_u8, vispr_params, clips_u8, clip_params, out_h: int, out_w: int):
    """The step's inputs from the raw batch and its draw: (v1, v2) (N, h, w, 3) and the
    clips (B, V, T, h, w, 3), float32 in [0, 1]."""
    images = vispr_u8[:, None]
    v1 = augment(images, vispr_params[0], out_h, out_w)[:, 0]
    v2 = augment(images, vispr_params[1], out_h, out_w)[:, 0]
    b, v = clips_u8.shape[:2]
    clips = augment(clips_u8.reshape((b * v,) + clips_u8.shape[2:]), clip_params, out_h, out_w)
    return v1, v2, clips.reshape((b, v) + clips.shape[1:])
