"""flax variables <-> port ``state_dict`` (the inverse of the layout rules of
ted_spad_tpu/utils/torch_convert.py, and back).

The port's modules carry the flax modules' names, so a variables tree
``{"params": ..., "batch_stats": ...}`` of numpy arrays maps onto a module's
``state_dict`` key by key, with these leaf rules:

- conv kernel: 1D (k,I,O)->(O,I,k), 2D (kh,kw,I,O)->(O,I,kh,kw),
  3D (kt,kh,kw,I,O)->(O,I,kt,kh,kw) (a grouped conv's I is its per-group width);
- dense kernel (I,O)->(O,I);
- ``scale``->``weight`` (BatchNorm, LayerNorm); ``batch_stats`` ``mean``/``var``
  -> ``running_mean``/``running_var``; every other leaf keeps its name.

Loading is strict: a key the module does not have, a module key the tree does not
fill, or a shape that differs raises. ``skip`` names subtrees that are not read:
the tree's are ignored and the module's keep their weights (e.g. ``FT_HEADS``, the
ft classifier and MLP head, for feature-path weights that do not carry them).

Buffers a module does not save (``persistent=False``: MViT's rel-pos index tables) have
no flax counterpart and are left out both ways.

``state_dict_to_flax`` applies the rules the other way, so the port writes variables
trees that the JAX package restores (``utils/checkpoint.py`` writes them as flax
msgpack); ``load_jax_checkpoint`` reads such a file into a module.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch
from torch import nn

_KERNEL_PERM = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_LEAF_NAMES = {"scale": "weight", "mean": "running_mean", "var": "running_var", "kernel": "weight"}


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def flax_to_state_dict(variables: Mapping[str, Any], skip: Iterable[str] = ()) -> dict[str, torch.Tensor]:
    """Flat ``{torch key: float32 tensor}`` from a flax variables tree."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown variable collections {sorted(unknown)}")
    skip = tuple(skip)
    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            dotted = ".".join(path)
            if any(dotted == s or dotted.startswith(s + ".") for s in skip):
                continue
            if isinstance(leaf, torch.Tensor):  # bfloat16 leaves of a msgpack checkpoint
                leaf = leaf.float().numpy()
            a = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                if a.ndim not in _KERNEL_PERM:
                    raise ValueError(f"{dotted}: unexpected kernel rank {a.ndim}")
                a = a.transpose(_KERNEL_PERM[a.ndim])
            key = ".".join(path[:-1] + (_LEAF_NAMES.get(path[-1], path[-1]),))
            out[key] = torch.tensor(a)  # a copy: the tree's arrays may be read-only
    return out


def load_jax_variables(module: nn.Module, variables: Mapping[str, Any],
                       skip: Iterable[str] = ()) -> nn.Module:
    """Replace every weight of ``module`` with the flax ``variables``, strictly."""
    sd = flax_to_state_dict(variables, skip)
    target = module.state_dict()
    extra = sorted(set(sd) - set(target))
    if extra:
        raise KeyError(f"variables hold keys the module does not: {extra[:8]}")
    skip = tuple(skip)
    missing = sorted(k for k in set(target) - set(sd) if not k.endswith("num_batches_tracked")
                     and not any(k.startswith(s + ".") for s in skip))
    if missing:
        raise KeyError(f"module keys the variables do not fill: {missing[:8]}")
    for key, value in sd.items():
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"{key}: variables shape {tuple(value.shape)} != module shape "
                             f"{tuple(target[key].shape)}")
    for key in set(target) - set(sd):  # num_batches_tracked counters and skipped subtrees
        sd[key] = target[key]
    module.load_state_dict(sd, strict=True)
    return module


# Subtrees of a flax WrapperI3D that the feature path does not read: the classifier
# and the MLP head.
FT_HEADS = ("i3d.fc", "mlp")


def load_npz_variables(path: str) -> dict[str, Any]:
    """A flax variables tree from an ``.npz`` whose keys are '/'-joined paths
    (e.g. ``params/encoder/stem/conv/kernel``), as
    ``np.savez(path, **{"/".join(k): v for k, v in flatten_dict(variables).items()})``
    writes it on the JAX side."""
    tree: dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


_KERNEL_MODULES = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)
_SCALE_MODULES = (nn.modules.batchnorm._NormBase, nn.LayerNorm)
_STAT_NAMES = {"running_mean": "mean", "running_var": "var"}


def state_dict_to_flax(module: nn.Module) -> dict[str, Any]:
    """The flax variables tree ``{"params": ..., "batch_stats": ...}`` of ``module``'s
    weights: fresh float32 numpy arrays (host copies that later in-place updates of
    the module cannot reach), laid out as the JAX package's module holds them.
    ``batch_stats`` is left out when the module has no running statistics."""
    tree: dict[str, dict] = {"params": {}, "batch_stats": {}}
    for prefix, sub in module.named_modules():
        path = tuple(prefix.split(".")) if prefix else ()
        leaves = [(n, t, "params") for n, t in sub.named_parameters(recurse=False)]
        leaves += [(n, t, "batch_stats") for n, t in sub.named_buffers(recurse=False)
                   if n != "num_batches_tracked" and n not in sub._non_persistent_buffers_set]
        for name, tensor, collection in leaves:
            a = tensor.detach().float().cpu().numpy().copy()
            if collection == "batch_stats":
                if name not in _STAT_NAMES:
                    raise KeyError(f"{prefix}.{name}: no flax counterpart for this buffer")
                name = _STAT_NAMES[name]
            elif name == "weight" and isinstance(sub, _KERNEL_MODULES):
                name = "kernel"
                a = np.ascontiguousarray(a.transpose(np.argsort(_KERNEL_PERM[a.ndim])))
            elif name == "weight" and isinstance(sub, _SCALE_MODULES):
                name = "scale"
            node = tree[collection]
            for part in path:
                node = node.setdefault(part, {})
            node[name] = a
    return {k: v for k, v in tree.items() if v or k == "params"}


def load_jax_checkpoint(module: nn.Module, path: str, key: str,
                        skip: Iterable[str] = ()) -> nn.Module:
    """Replace every weight of ``module`` with the variables stored under ``key`` of
    a flax-msgpack checkpoint (``{fa,ft,mgfn}_model_state_dict``), as the JAX
    package's loaders do; a file holding bare variables is accepted too."""
    from ted_spad_tpu_torch.utils.checkpoint import load_checkpoint

    state = load_checkpoint(path)
    return load_jax_variables(module, state.get(key, state), skip)
