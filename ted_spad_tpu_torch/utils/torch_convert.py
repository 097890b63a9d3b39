"""torch -> flax-layout pretrained-weight conversion (counterpart of
ted_spad_tpu/utils/torch_convert.py).

The reference seeds its models from torch checkpoints: Kinetics I3Res50
(``i3d_r50_kinetics.pth``, model_loaders.py:192), ImageNet InceptionI3d
(``rgb_imagenet.pt``, :178), torchvision ImageNet ResNet-50 (:159-161), the smp UNet++
ImageNet ResNet-18 encoder (:21-23), torchvision ``r3d_18`` (:203-204) and ``mvit_v2_s``
(:219-221). This module turns those state_dicts into the variables trees the port's
checkpoints hold (the JAX package's layout, ``utils/jax_weights.py``), so a run starts
from the published weights in either package.

Layout rules: conv2d (O,I,kh,kw)->(kh,kw,I,O); conv3d (O,I,kt,kh,kw)->(kt,kh,kw,I,O);
linear (O,I)->(I,O); BN weight/bias->scale/bias (params), running_mean/var->mean/var
(batch_stats). The converters are numpy only and take torch tensors or numpy arrays;
``utils/reference_layout.py`` applies the rules the other way.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def conv_kernel(t) -> np.ndarray:
    a = _np(t)
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 5:
        return a.transpose(2, 3, 4, 1, 0)
    raise ValueError(f"unexpected conv kernel rank {a.ndim}")


def linear_kernel(t) -> np.ndarray:
    return _np(t).transpose(1, 0)


def convbn_entry(sd: Mapping[str, Any], conv_key: str, bn_key: str | None):
    """(params, batch_stats) subtrees for one ConvBN given torch key prefixes."""
    params: dict[str, Any] = {"conv": {"kernel": conv_kernel(sd[conv_key + ".weight"])}}
    if conv_key + ".bias" in sd:
        params["conv"]["bias"] = _np(sd[conv_key + ".bias"])
    stats = {}
    if bn_key is not None:
        params["bn"] = {"scale": _np(sd[bn_key + ".weight"]), "bias": _np(sd[bn_key + ".bias"])}
        stats["bn"] = {
            "mean": _np(sd[bn_key + ".running_mean"]),
            "var": _np(sd[bn_key + ".running_var"]),
        }
    return params, stats


def _merge(params, stats, name, entry):
    p, s = entry
    params[name] = p
    if s:
        stats[name] = s


# ---------------------------------------------------------------------------
# torchvision 2D ResNets -> ResNet2D (fb r50, UNet++ r18 encoder)
# ---------------------------------------------------------------------------

_RESNET_LAYERS = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}
_RESNET_BLOCK_CONVS = {"resnet18": 2, "resnet50": 3}


def convert_resnet2d(sd: Mapping[str, Any], arch: str = "resnet50", depth: int = 5):
    """torchvision resnet state_dict -> our ResNet2D {'params', 'batch_stats'} subtree
    (names: stem, layer{L}_{B}.conv{i}/downsample)."""
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    _merge(params, stats, "stem", convbn_entry(sd, "conv1", "bn1"))
    n_convs = _RESNET_BLOCK_CONVS[arch]
    for li, n_blocks in enumerate(_RESNET_LAYERS[arch]):
        if li + 2 > depth:
            break
        for bi in range(n_blocks):
            bp: dict[str, Any] = {}
            bs: dict[str, Any] = {}
            pre = f"layer{li + 1}.{bi}"
            for ci in range(1, n_convs + 1):
                _merge(bp, bs, f"conv{ci}", convbn_entry(sd, f"{pre}.conv{ci}", f"{pre}.bn{ci}"))
            if f"{pre}.downsample.0.weight" in sd:
                _merge(bp, bs, "downsample", convbn_entry(sd, f"{pre}.downsample.0", f"{pre}.downsample.1"))
            params[f"layer{li + 1}_{bi}"] = bp
            stats[f"layer{li + 1}_{bi}"] = bs
    return {"params": params, "batch_stats": stats}


def convert_resnet50_classifier(sd: Mapping[str, Any], replace_fc: bool = True):
    """torchvision resnet50 -> ResNet50Classifier variables. ``replace_fc`` keeps our
    randomly-initialized head (model_loaders.py:163-166 replaces fc)."""
    tree = convert_resnet2d(sd, "resnet50", depth=5)
    variables = {"params": {"backbone": tree["params"]}, "batch_stats": {"backbone": tree["batch_stats"]}}
    if not replace_fc and "fc.weight" in sd:
        variables["params"]["fc"] = {"kernel": linear_kernel(sd["fc.weight"]), "bias": _np(sd["fc.bias"])}
    return variables


# ---------------------------------------------------------------------------
# I3Res50 Kinetics seed -> WrapperI3D.i3d (model_loaders.py:185-197)
# ---------------------------------------------------------------------------

_I3_LAYERS = (3, 4, 6, 3)


def convert_i3res50(sd: Mapping[str, Any], include_fc: bool = False):
    """pytorch-resnet3d I3Res50 state_dict (conv1/bn1/layer{L}.{B}.conv{i}/fc; possibly
    with FrozenBN 'scale' keys — handled like model_loaders.py:80) -> i3d subtree."""
    sd = {k.replace(".scale", ".weight") if k.endswith(".scale") else k: v for k, v in sd.items()}
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    _merge(params, stats, "stem", convbn_entry(sd, "conv1", "bn1"))
    for li, n_blocks in enumerate(_I3_LAYERS):
        for bi in range(n_blocks):
            pre = f"layer{li + 1}.{bi}"
            bp: dict[str, Any] = {}
            bs: dict[str, Any] = {}
            for ci in (1, 2, 3):
                _merge(bp, bs, f"conv{ci}", convbn_entry(sd, f"{pre}.conv{ci}", f"{pre}.bn{ci}"))
            if f"{pre}.downsample.0.weight" in sd:
                _merge(bp, bs, "downsample", convbn_entry(sd, f"{pre}.downsample.0", f"{pre}.downsample.1"))
            params[f"blocks_layer{li + 1}_{bi}"] = bp
            stats[f"blocks_layer{li + 1}_{bi}"] = bs
    if include_fc and "fc.weight" in sd:
        params["fc"] = {"kernel": linear_kernel(sd["fc.weight"]), "bias": _np(sd["fc.bias"])}
    return {"params": params, "batch_stats": stats}


def load_kinetics_into_wrapper(variables, sd: Mapping[str, Any], num_classes: int):
    """build_largei3d_classifier semantics (model_loaders.py:185-197): load the Kinetics
    backbone into wrapper.i3d, keep our fresh fc (replaced when classes != 400) + mlp."""
    tree = convert_i3res50(sd, include_fc=(num_classes == 400))
    new_params = dict(variables["params"])
    i3d_params = dict(new_params["i3d"])
    i3d_params.update(tree["params"])
    new_params["i3d"] = i3d_params
    new_stats = dict(variables.get("batch_stats", {}))
    i3d_stats = dict(new_stats.get("i3d", {}))
    i3d_stats.update(tree["batch_stats"])
    new_stats["i3d"] = i3d_stats
    return {**variables, "params": new_params, "batch_stats": new_stats}


# ---------------------------------------------------------------------------
# InceptionI3d rgb_imagenet.pt -> InceptionI3d (model_loaders.py:171-182)
# ---------------------------------------------------------------------------

_I3D_BRANCHES = {"b0": "b0", "b1a": "b1a", "b1b": "b1b", "b2a": "b2a", "b2b": "b2b", "b3b": "b3b"}


def _unit3d(sd, prefix: str):
    params: dict[str, Any] = {"conv3d": {"kernel": conv_kernel(sd[prefix + ".conv3d.weight"])}}
    if prefix + ".conv3d.bias" in sd:
        params["conv3d"]["bias"] = _np(sd[prefix + ".conv3d.bias"])
    stats = {}
    if prefix + ".bn.weight" in sd:
        params["bn"] = {"scale": _np(sd[prefix + ".bn.weight"]), "bias": _np(sd[prefix + ".bn.bias"])}
        stats["bn"] = {
            "mean": _np(sd[prefix + ".bn.running_mean"]),
            "var": _np(sd[prefix + ".bn.running_var"]),
        }
    return params, stats


def convert_inception_i3d(sd: Mapping[str, Any], include_logits: bool = False):
    """Official I3D checkpoint naming (Conv3d_1a_7x7.conv3d.*, Mixed_3b.b0.conv3d.*...)."""
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    for ours, theirs in (("conv_1a", "Conv3d_1a_7x7"), ("conv_2b", "Conv3d_2b_1x1"), ("conv_2c", "Conv3d_2c_3x3")):
        _merge(params, stats, ours, _unit3d(sd, theirs))
    for ep in ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f", "Mixed_5b", "Mixed_5c"):
        bp: dict[str, Any] = {}
        bs: dict[str, Any] = {}
        for branch in _I3D_BRANCHES:
            _merge(bp, bs, branch, _unit3d(sd, f"{ep}.{branch}"))
        params[f"mixed_{ep}"] = bp
        stats[f"mixed_{ep}"] = bs
    if include_logits and "logits.conv3d.weight" in sd:
        params["logits_conv"] = {
            "kernel": conv_kernel(sd["logits.conv3d.weight"]),
            "bias": _np(sd["logits.conv3d.bias"]),
        }
    return {"params": params, "batch_stats": stats}


def load_imagenet_into_unetpp(variables, sd: Mapping[str, Any]):
    """smp UnetPlusPlus(resnet18, encoder_weights='imagenet') seed (model_loaders.py:18-30):
    smp's resnet18 encoder IS torchvision's resnet18 state_dict (conv1/bn1/layerL.B.*) —
    load it into UNetPlusPlus.encoder (depth 4), keep the randomly-init decoder/head."""
    tree = convert_resnet2d(sd, "resnet18", depth=4)
    new_params = dict(variables["params"])
    enc_p = dict(new_params.get("encoder", {}))
    enc_p.update(tree["params"])
    new_params["encoder"] = enc_p
    new_stats = dict(variables.get("batch_stats", {}))
    enc_s = dict(new_stats.get("encoder", {}))
    enc_s.update(tree["batch_stats"])
    new_stats["encoder"] = enc_s
    return {**variables, "params": new_params, "batch_stats": new_stats}


# ---------------------------------------------------------------------------
# torchvision video r3d_18 -> R3D18 (wrapper_r3d_18, model_loaders.py:200-215)
# ---------------------------------------------------------------------------


def convert_r3d18(sd: Mapping[str, Any], include_fc: bool = False):
    """torchvision video-ResNet naming (stem.0/.1, layerL.B.conv{1,2}.{0,1},
    layerL.B.downsample.{0,1}, fc) -> R3D18 variables (stem, blocks_{0..7}, fc)."""
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    _merge(params, stats, "stem", convbn_entry(sd, "stem.0", "stem.1"))
    for li in range(4):
        for bi in range(2):
            pre = f"layer{li + 1}.{bi}"
            bp: dict[str, Any] = {}
            bs: dict[str, Any] = {}
            # conv1/conv2 are Sequential(Conv3d, BN[, ReLU]) in torchvision video resnet.
            _merge(bp, bs, "conv1", convbn_entry(sd, f"{pre}.conv1.0", f"{pre}.conv1.1"))
            _merge(bp, bs, "conv2", convbn_entry(sd, f"{pre}.conv2.0", f"{pre}.conv2.1"))
            if f"{pre}.downsample.0.weight" in sd:
                _merge(bp, bs, "downsample", convbn_entry(sd, f"{pre}.downsample.0", f"{pre}.downsample.1"))
            params[f"blocks_{li * 2 + bi}"] = bp
            stats[f"blocks_{li * 2 + bi}"] = bs
    if include_fc and "fc.weight" in sd:
        params["fc"] = {"kernel": linear_kernel(sd["fc.weight"]), "bias": _np(sd["fc.bias"])}
    return {"params": params, "batch_stats": stats}


def load_r3d18_weights(variables, sd: Mapping[str, Any], num_classes: int):
    """wrapper_r3d_18 semantics (model_loaders.py:200-215): Kinetics backbone, fresh fc
    unless the class count matches the 400-way seed."""
    tree = convert_r3d18(sd, include_fc=(num_classes == 400))
    return {
        **variables,
        "params": {**variables["params"], **tree["params"]},
        "batch_stats": {**variables.get("batch_stats", {}), **tree["batch_stats"]},
    }


# ---------------------------------------------------------------------------
# torchvision mvit_v2_s -> MViTv2S (wrapper_mvit, model_loaders.py:217-232)
# ---------------------------------------------------------------------------


def _ln(sd, key):
    return {"scale": _np(sd[key + ".weight"]), "bias": _np(sd[key + ".bias"])}


def _linear(sd, key):
    p = {"kernel": linear_kernel(sd[key + ".weight"])}
    if key + ".bias" in sd:
        p["bias"] = _np(sd[key + ".bias"])
    return p


def convert_mvitv2(
    sd: Mapping[str, Any],
    depths: tuple[int, ...] = (1, 2, 11, 2),
    include_head: bool = False,
):
    """torchvision mvit_v2_s state_dict naming (models/video/mvit.py: conv_proj,
    pos_encoding.class_token, blocks.{i}.{norm1,norm2,attn.*,mlp.{0,3},project},
    norm, head.1) -> MViTv2S params. Pure-LayerNorm model: no batch_stats.

    The naming contract is pinned by the hand-built oracle in tests/test_torch_convert.py
    (the same key layout)."""
    params: dict[str, Any] = {}
    params["patch_embed"] = {
        "kernel": conv_kernel(sd["conv_proj.weight"]),
        "bias": _np(sd["conv_proj.bias"]),
    }
    params["cls_token"] = _np(sd["pos_encoding.class_token"]).reshape(1, 1, -1)

    block_of = []  # global index -> (stage, block)
    for si, d in enumerate(depths):
        block_of += [(si, bi) for bi in range(d)]

    for i, (si, bi) in enumerate(block_of):
        pre = f"blocks.{i}"
        bp: dict[str, Any] = {
            "norm1": _ln(sd, f"{pre}.norm1"),
            "norm2": _ln(sd, f"{pre}.norm2"),
        }
        attn: dict[str, Any] = {"qkv": _linear(sd, f"{pre}.attn.qkv")}
        for pool in ("pool_q", "pool_k", "pool_v"):
            attn[pool] = {"kernel": conv_kernel(sd[f"{pre}.attn.{pool}.pool.weight"])}
            attn[f"{pool}_norm"] = _ln(sd, f"{pre}.attn.{pool}.norm_act.0")
        for axis in ("t", "h", "w"):
            attn[f"rel_pos_{axis}"] = _np(sd[f"{pre}.attn.rel_pos_{axis}"])
        # project is a bare Linear, or Sequential(Linear, Dropout) when dropout > 0.
        proj_key = f"{pre}.attn.project" if f"{pre}.attn.project.weight" in sd else f"{pre}.attn.project.0"
        attn["proj"] = _linear(sd, proj_key)
        bp["attn"] = attn
        if f"{pre}.project.weight" in sd:  # skip projection at stage transitions
            bp["proj_skip"] = _linear(sd, f"{pre}.project")
        bp["mlp_fc1"] = _linear(sd, f"{pre}.mlp.0")
        bp["mlp_fc2"] = _linear(sd, f"{pre}.mlp.3")
        params[f"stage{si}_block{bi}"] = bp

    params["norm"] = _ln(sd, "norm")
    if include_head and "head.1.weight" in sd:
        params["head"] = _linear(sd, "head.1")
    return {"params": params}


def load_mvitv2_weights(variables, sd: Mapping[str, Any], num_classes: int):
    """wrapper_mvit semantics (model_loaders.py:217-232): pretrained trunk, head replaced
    for the target class count (kept only for the 400-way seed)."""
    tree = convert_mvitv2(sd, include_head=(num_classes == 400))
    return {**variables, "params": {**variables["params"], **tree["params"]}}


def load_torch_checkpoint(path: str) -> dict[str, Any]:
    """The state_dict in a ``.pth`` / ``.pt`` (read with ``torch.load(map_location="cpu",
    weights_only=True)``: a seed file holds weights, and the port reads it with torch
    itself, so no pickled code runs) or a converted ``.npz``. A bare state_dict is
    returned as is; one under ``state_dict``, ``model_state_dict`` or
    ``{fa,ft,fb}_model_state_dict`` is unwrapped. Anything else raises ValueError."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    import pickle

    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path} is not a weights-only torch checkpoint: {e}") from e
    if isinstance(obj, dict) and all(hasattr(v, "shape") for v in obj.values()):
        return obj
    for key in ("state_dict", "model_state_dict", "fa_model_state_dict", "ft_model_state_dict",
                "fb_model_state_dict"):
        if isinstance(obj, dict) and key in obj:
            return obj[key]
    raise ValueError(f"unrecognized checkpoint structure in {path}")


SEED_KINDS = ("largei3d", "i3d", "r50", "unet++", "r3d_18", "mvitv2")


def convert_seed_payload(
    kind: str,
    sd: Mapping[str, Any],
    *,
    num_classes: int = 102,
    num_pa: int = 7,
    clip_shape: tuple[int, int, int] | None = None,
    device: str = "cuda",
) -> dict[str, Any]:
    """One seed kind -> its checkpoint payload, shared by ``convert_weights`` and
    ``run_parity`` so the kind -> converter -> payload-key mapping cannot drift.

    ``kind`` follows the reference's loader switch (model_loaders.py): ``largei3d``
    (i3d_r50_kinetics.pth, :185-197), ``i3d`` (rgb_imagenet.pt, :171-182), ``unet++``
    (smp ImageNet resnet18 encoder, :18-30), ``r50`` (fb predictor, :157-168),
    ``r3d_18`` (:203-204), ``mvitv2`` (:219-221). The template is the port's seeded
    model (``load_*_model`` on ``device``, float32), read back as a variables tree; the converted subtree replaces its part of it, as the JAX package merges:
    the Kinetics fc / logits / head only at 400 classes, the UNet++ encoder at depth 4
    (decoder and head keep their init), the r50 payload the headless predictor.
    ``clip_shape`` sizes mvitv2's rel-pos tables, which follow the input size, so it
    defaults to the torchvision-native (16, 224, 224) there; the other kinds are
    size-agnostic (JAX's ``image_size``, the size flax initializes the 2D models at,
    has no counterpart: torch modules need no dummy input). The payload's keys are
    ``{fa,ft,fb}_model_state_dict``, so the file loads through
    ``load_*_model(saved_model_file=)`` in both packages."""
    from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model
    from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax

    if clip_shape is None:
        clip_shape = (16, 224, 224) if kind == "mvitv2" else (16, 64, 64)
    kw = dict(dtype="float32", device=device)

    def ft_template(arch: str) -> dict[str, Any]:
        return state_dict_to_flax(load_ft_model(arch, num_classes=num_classes,
                                                clip_shape=clip_shape, **kw))

    if kind == "largei3d":
        return {"ft_model_state_dict": load_kinetics_into_wrapper(ft_template("largei3d"), sd,
                                                                  num_classes)}
    if kind == "i3d":
        variables = ft_template("i3d")
        tree = convert_inception_i3d(sd, include_logits=(num_classes == 400))
        return {"ft_model_state_dict": {
            **variables,
            "params": {**variables["params"], **tree["params"]},
            "batch_stats": {**variables["batch_stats"], **tree["batch_stats"]},
        }}
    if kind == "unet++":
        variables = state_dict_to_flax(load_fa_model("unet++", **kw))
        return {"fa_model_state_dict": load_imagenet_into_unetpp(variables, sd)}
    if kind == "r3d_18":
        return {"ft_model_state_dict": load_r3d18_weights(ft_template("r3d_18"), sd, num_classes)}
    if kind == "mvitv2":
        return {"ft_model_state_dict": load_mvitv2_weights(ft_template("mvitv2"), sd, num_classes)}
    if kind == "r50":
        variables = state_dict_to_flax(load_fb_model("r50", num_pa=num_pa, **kw))
        conv = convert_resnet50_classifier(sd, replace_fc=True)
        return {"fb_model_state_dict": {
            **variables,
            "params": {**variables["params"], **conv["params"]},
            "batch_stats": {**variables["batch_stats"], **conv["batch_stats"]},
        }}
    raise ValueError(f"unknown seed kind {kind!r}")
