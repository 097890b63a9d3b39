"""Model size estimation (counterpart of ted_spad_tpu/utils/model_size.py; the
reference's ``modelsize()``, anomaly_detection_mgfn/utils/utils.py:61-91). Every
function takes a module, read as its flax variables tree
(``utils.jax_weights.state_dict_to_flax``), or such a tree itself, so the port's
report for a model is the JAX package's for the same model, string for string: BN
running statistics count as state, and ``num_batches_tracked``, which the tree does
not hold, does not count."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _tree(variables: Any) -> Any:
    if isinstance(variables, torch.nn.Module):
        from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax

        return state_dict_to_flax(variables)
    return variables


def _leaves(tree: Any):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "shape"):
        yield tree


def param_count(variables: Any) -> int:
    variables = _tree(variables)
    params = variables.get("params", variables) if isinstance(variables, Mapping) else variables
    return int(sum(np.prod(x.shape) for x in _leaves(params)))


def tree_bytes(tree: Any) -> int:
    return sum(int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
               for leaf in _leaves(_tree(tree)))


def model_size_report(variables: Any, name: str = "model") -> str:
    """Human-readable parameter/state summary (params + batch_stats, MB)."""
    variables = _tree(variables)
    n = param_count(variables)
    is_map = isinstance(variables, Mapping)
    pb = tree_bytes(variables.get("params", {})) if is_map else tree_bytes(variables)
    sb = tree_bytes({k: v for k, v in variables.items() if k != "params"}) if is_map else 0
    return (
        f"{name}: {n / 1e6:.2f}M params, {pb / 1e6:.1f} MB params, "
        f"{sb / 1e6:.1f} MB non-param state"
    )
