"""Seeded weights for a module's parameters and buffers, made on the device.

The draw is one ``randn`` and one ``rand`` call on a generator of the device, sliced
leaf by leaf in the module's own order, so a seed gives the same weights on every run.
Each leaf is scaled by its role, read from the module that holds it:

- convolutions and dense layers: He-normal for 2D and 3D convolutions (gain 2, the
  ReLU networks), fan-in normal for the rest; their biases N(0, 0.05);
- BatchNorm: scale 1 + N(0, 0.1) (a quarter of that on the last BatchNorm of a
  residual branch, so the eval-mode residual sums stay in range), shift N(0, 0.1),
  running mean N(0, 0.1), running variance U(0.5, 1.5): every BatchNorm folds to
  something other than the identity;
- LayerNorm and the channel LayerNorms (``g`` / ``b``): 1 + N(0, 0.1) and N(0, 0.1).
"""

from __future__ import annotations

import math
import re

import torch
from torch import nn

_RESIDUAL_LAST_BN = re.compile(r"(blocks_layer\d+_\d+\.conv3|encoder\.layer\d+_\d+\.conv2"
                               r"|layer\d+_\d+\.conv3)\.bn$")


def _leaves(model: nn.Module):
    """(full name, tensor template, role) of every parameter and floating buffer."""
    for mod_name, mod in model.named_modules():
        prefix = mod_name + "." if mod_name else ""
        is_bn = isinstance(mod, nn.modules.batchnorm._NormBase)
        is_ln = isinstance(mod, nn.LayerNorm) or {"g", "b"} <= set(mod._parameters)
        gain = 2.0 if isinstance(mod, (nn.Conv2d, nn.Conv3d)) else 1.0
        for leaf, t in list(mod._parameters.items()) + list(mod._buffers.items()):
            if t is None:
                continue
            name = prefix + leaf
            if not t.is_floating_point():
                yield name, t, "zero"
            elif is_bn:
                residual = bool(_RESIDUAL_LAST_BN.search(mod_name))
                yield name, t, {"weight": "bn_scale_res" if residual else "bn_scale",
                                "bias": "small", "running_mean": "small",
                                "running_var": "var"}[leaf]
            elif is_ln:
                yield name, t, "ln_scale" if leaf in ("weight", "g") else "small"
            elif t.dim() >= 2:
                yield name, t, ("fan_in", gain)
            else:
                yield name, t, "bias"


def make_weights(model: nn.Module, seed: int, device, dtype: torch.dtype) -> dict:
    """{name: tensor} for every leaf of ``model`` (whose own tensors may live on the
    meta device), made on ``device`` from ``seed`` in float32 and returned in
    ``dtype`` (integer buffers as they are)."""
    leaves = list(_leaves(model))
    n = sum(t.numel() for _, t, _ in leaves)
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n, generator=g, device=device)
    uniform = torch.rand(n, generator=g, device=device)
    out, at = {}, 0
    for name, t, role in leaves:
        k = t.numel()
        z = normal[at:at + k].view(t.shape)
        if role == "zero":
            out[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
            at += k
            continue
        if isinstance(role, tuple):
            fan_in = math.prod(t.shape[1:])
            v = z * math.sqrt(role[1] / fan_in)
        elif role == "bias":
            v = 0.05 * z
        elif role == "small":
            v = 0.1 * z
        elif role in ("bn_scale", "ln_scale"):
            v = 1.0 + 0.1 * z
        elif role == "bn_scale_res":
            v = 0.25 * (1.0 + 0.1 * z)
        else:  # running variance
            v = 0.5 + uniform[at:at + k].view(t.shape)
        out[name] = v.to(dtype)
        at += k
    return out


def place(meta: nn.Module, device, weights: dict, dtype: torch.dtype,
          memory_format=None) -> nn.Module:
    """A module built on the meta device, given storage on ``device`` and filled with
    ``weights``; cast to ``dtype``, in eval mode, without gradients, in
    ``memory_format`` where given (the port's loaders place their models so)."""
    model = meta.to_empty(device=device)
    model.load_state_dict(weights)
    model = model.to(dtype).eval().requires_grad_(False)
    if memory_format is not None:
        model = model.to(memory_format=memory_format)
    return model
