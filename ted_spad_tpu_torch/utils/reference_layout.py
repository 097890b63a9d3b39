"""State_dicts in the reference's torch key layout, from the port's seeded models: the
inverse of each converter in ``utils/torch_convert.py``.

``reference_state_dict(kind)`` builds the port's model of a seed kind from a
``torch.Generator``, moves its BN affines and running statistics off their init (so
an eval-mode forward reads them), and lays its weights out as the published seed file
holds them: pytorch-resnet3d's I3Res50 (``conv1``, ``layerL.B.conv{i}`` / ``bn{i}``,
``fc``), the official InceptionI3d (``Conv3d_1a_7x7.conv3d``, ``Mixed_3b.b0.bn``,
``logits.conv3d``), torchvision's ResNet-18 trunk (smp's UNet++ encoder) and
ResNet-50, ``r3d_18`` (``stem.0``, ``layerL.B.conv1.0``) and ``mvit_v2_s``
(``conv_proj``, ``blocks.{i}.attn.pool_q.pool``, ``head.1``), BN counters included.
Converting such a state_dict gives back the model's weights bit for bit (the rules
are transposes and renames). ``write_dry_run_seeds`` writes the three files the
parity dry run converts, in place of the published ones.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

# The published files each kind stands for (scripts/run_parity.py's names).
SEED_FILES = {"largei3d": "i3d_r50_kinetics.pth", "unet++": "resnet18_imagenet.pth",
              "r50": "resnet50_imagenet.pth"}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def conv_weight(kernel: np.ndarray) -> torch.Tensor:
    """flax conv kernel (kh,kw,I,O) / (kt,kh,kw,I,O) -> torch (O,I,kh,kw) / (O,I,kt,kh,kw)."""
    perm = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[kernel.ndim]
    return _t(kernel.transpose(perm))


def _linear(sd: dict, key: str, p: Mapping[str, Any]) -> None:
    sd[key + ".weight"] = _t(p["kernel"].T)
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _norm(sd: dict, key: str, p: Mapping[str, Any], s: Mapping[str, Any] | None = None) -> None:
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])
    if s is not None:
        sd[key + ".running_mean"] = _t(s["mean"])
        sd[key + ".running_var"] = _t(s["var"])
        sd[key + ".num_batches_tracked"] = torch.tensor(0)


def _convbn(sd: dict, p, s, conv_key: str, bn_key: str, conv_name: str = "conv") -> None:
    sd[conv_key + ".weight"] = conv_weight(p[conv_name]["kernel"])
    if "bias" in p[conv_name]:
        sd[conv_key + ".bias"] = _t(p[conv_name]["bias"])
    if "bn" in p:
        _norm(sd, bn_key, p["bn"], s["bn"])


def resnet_state_dict(params, stats, block_prefix: str = "layer") -> dict[str, torch.Tensor]:
    """ResNet2D / I3Res50 trunk -> torchvision / pytorch-resnet3d naming (``stem`` ->
    conv1 + bn1, ``{block_prefix}{L}_{B}.conv{i}`` -> ``layer{L}.{B}.conv{i}`` +
    ``bn{i}``, ``downsample`` -> ``downsample.0`` + ``.1``, ``fc``)."""
    sd: dict[str, torch.Tensor] = {}
    _convbn(sd, params["stem"], stats["stem"], "conv1", "bn1")
    for name, block in params.items():
        if not name.startswith(block_prefix):
            continue
        layer, index = name[len(block_prefix):].split("_")
        pre = f"layer{layer}.{index}"
        for sub in block:
            if sub == "downsample":
                _convbn(sd, block[sub], stats[name][sub], f"{pre}.downsample.0", f"{pre}.downsample.1")
            else:
                _convbn(sd, block[sub], stats[name][sub], f"{pre}.{sub}", f"{pre}.bn{sub[4:]}")
    if "fc" in params:
        _linear(sd, "fc", params["fc"])
    return sd


_I3D_UNITS = {"conv_1a": "Conv3d_1a_7x7", "conv_2b": "Conv3d_2b_1x1", "conv_2c": "Conv3d_2c_3x3"}


def inception_i3d_state_dict(params, stats) -> dict[str, torch.Tensor]:
    """InceptionI3d -> the official checkpoint naming (``Conv3d_1a_7x7.conv3d``,
    ``Mixed_3b.b1a.bn``, ``logits.conv3d``)."""
    sd: dict[str, torch.Tensor] = {}
    for name, unit in params.items():
        if name in _I3D_UNITS:
            _convbn(sd, unit, stats[name], f"{_I3D_UNITS[name]}.conv3d", f"{_I3D_UNITS[name]}.bn",
                    "conv3d")
        elif name.startswith("mixed_"):
            ep = name[len("mixed_"):]
            for branch, p in unit.items():
                _convbn(sd, p, stats[name][branch], f"{ep}.{branch}.conv3d", f"{ep}.{branch}.bn",
                        "conv3d")
    if "logits_conv" in params:
        sd["logits.conv3d.weight"] = conv_weight(params["logits_conv"]["kernel"])
        sd["logits.conv3d.bias"] = _t(params["logits_conv"]["bias"])
    return sd


def r3d18_state_dict(params, stats) -> dict[str, torch.Tensor]:
    """R3D18 -> torchvision's video-ResNet naming (``stem.0`` / ``.1``,
    ``layerL.B.conv{1,2}.{0,1}``, ``downsample.{0,1}``, ``fc``)."""
    sd: dict[str, torch.Tensor] = {}
    _convbn(sd, params["stem"], stats["stem"], "stem.0", "stem.1")
    for k in range(8):
        name, pre = f"blocks_{k}", f"layer{k // 2 + 1}.{k % 2}"
        for sub in params[name]:
            key = f"{pre}.downsample" if sub == "downsample" else f"{pre}.{sub}"
            _convbn(sd, params[name][sub], stats[name][sub], f"{key}.0", f"{key}.1")
    if "fc" in params:
        _linear(sd, "fc", params["fc"])
    return sd


def mvitv2_state_dict(params) -> dict[str, torch.Tensor]:
    """MViTv2S -> torchvision's ``mvit_v2_s`` naming. Blocks are numbered globally in
    stage order, as torchvision's ``blocks`` list holds them."""
    sd: dict[str, torch.Tensor] = {}
    sd["conv_proj.weight"] = conv_weight(params["patch_embed"]["kernel"])
    sd["conv_proj.bias"] = _t(params["patch_embed"]["bias"])
    sd["pos_encoding.class_token"] = _t(params["cls_token"].reshape(-1))
    blocks = sorted((tuple(int(x) for x in name[len("stage"):].split("_block")), name)
                    for name in params if name.startswith("stage"))
    for i, (_, name) in enumerate(blocks):
        bp, pre = params[name], f"blocks.{i}"
        _norm(sd, f"{pre}.norm1", bp["norm1"])
        attn = bp["attn"]
        _linear(sd, f"{pre}.attn.qkv", attn["qkv"])
        for pool in ("pool_q", "pool_k", "pool_v"):
            sd[f"{pre}.attn.{pool}.pool.weight"] = conv_weight(attn[pool]["kernel"])
            _norm(sd, f"{pre}.attn.{pool}.norm_act.0", attn[f"{pool}_norm"])
        for axis in ("t", "h", "w"):
            sd[f"{pre}.attn.rel_pos_{axis}"] = _t(attn[f"rel_pos_{axis}"])
        _linear(sd, f"{pre}.attn.project", attn["proj"])
        if "proj_skip" in bp:
            _linear(sd, f"{pre}.project", bp["proj_skip"])
        _norm(sd, f"{pre}.norm2", bp["norm2"])
        _linear(sd, f"{pre}.mlp.0", bp["mlp_fc1"])
        _linear(sd, f"{pre}.mlp.3", bp["mlp_fc2"])
    _norm(sd, "norm", params["norm"])
    if "head" in params:
        _linear(sd, "head.1", params["head"])
    return sd


def _perturb_norms(model: torch.nn.Module, g: torch.Generator) -> torch.nn.Module:
    """BN affines and running statistics drawn off (1, 0, 0, 1), as trained ones are."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._NormBase):
                m.weight.copy_(torch.empty_like(m.weight).uniform_(0.8, 1.2, generator=g))
                m.bias.copy_(torch.empty_like(m.bias).normal_(0.0, 0.05, generator=g))
                m.running_mean.copy_(torch.empty_like(m.running_mean).normal_(0.0, 0.05, generator=g))
                m.running_var.copy_(torch.empty_like(m.running_var).uniform_(0.8, 1.2, generator=g))
    return model


def module_state_dict(kind: str, model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The weights of the port's model of ``kind`` in that seed's reference layout: what
    the kind's converter reads. ``model`` is the kind's ``load_*_model`` module or its
    converted part: a WrapperI3D or its I3Res50, a UNetPlusPlus (its encoder) or a
    ResNet-18 trunk, a ResNet50Classifier, an InceptionI3d, R3D18 or MViTv2S.
    float32 CPU tensors."""
    from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax

    tree = state_dict_to_flax(model)
    params, stats = tree["params"], tree.get("batch_stats", {})
    if kind == "largei3d":
        return resnet_state_dict(params.get("i3d", params), stats.get("i3d", stats),
                                 block_prefix="blocks_layer")
    if kind == "i3d":
        return inception_i3d_state_dict(params, stats)
    if kind == "unet++":
        return resnet_state_dict(params.get("encoder", params), stats.get("encoder", stats))
    if kind == "r50":
        sd = resnet_state_dict(params["backbone"], stats["backbone"])
        _linear(sd, "fc", params["fc"])
        return sd
    if kind == "r3d_18":
        return r3d18_state_dict(params, stats)
    if kind == "mvitv2":
        return mvitv2_state_dict(params)
    raise ValueError(f"unknown seed kind {kind!r}")


def reference_state_dict(kind: str, *, seed: int = 0,
                         clip_shape: tuple[int, int, int] = (16, 224, 224)) -> dict[str, torch.Tensor]:
    """A seeded state_dict of ``kind`` (torch_convert.SEED_KINDS) in the published seed's
    key layout and shapes: the Kinetics-400 classifier for the video kinds, the
    1000-way ImageNet fc for ``r50``, the headless ResNet-18 trunk (all four layers,
    as smp's encoder file holds it) for ``unet++``. ``clip_shape`` sizes mvitv2's
    rel-pos tables. float32 CPU tensors."""
    from ted_spad_tpu_torch.models import (
        InceptionI3d, MViTv2S, R3D18, ResNet2D, ResNet50Classifier, WrapperI3D,
    )

    g = torch.Generator().manual_seed(seed)
    builders = {
        "largei3d": lambda: WrapperI3D(400, generator=g).i3d,
        "i3d": lambda: InceptionI3d(400, generator=g),
        "unet++": lambda: ResNet2D("basic", (2, 2, 2, 2), depth=5, generator=g),
        "r50": lambda: ResNet50Classifier(1000, generator=g),
        "r3d_18": lambda: R3D18(400, generator=g),
        "mvitv2": lambda: MViTv2S(400, clip_shape=tuple(clip_shape), generator=g),
    }
    if kind not in builders:
        raise ValueError(f"unknown seed kind {kind!r}")
    return module_state_dict(kind, _perturb_norms(builders[kind](), g))


def write_dry_run_seeds(out_dir: str, seed: int = 0) -> dict[str, str]:
    """The parity dry run's seed files: ``reference_state_dict`` of ``largei3d``,
    ``unet++`` and ``r50`` saved with ``torch.save`` under the published files' names
    (``SEED_FILES``) in ``out_dir``, so they go through the real
    ``load_torch_checkpoint`` -> ``convert_seed_payload`` path. Returns {kind: path}."""
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for kind, name in SEED_FILES.items():
        out[kind] = os.path.join(out_dir, name)
        torch.save(reference_state_dict(kind, seed=seed), out[kind])
    return out
