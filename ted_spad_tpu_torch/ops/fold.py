"""What the eval fast forms (ops/fast_unetpp.py, ops/fast_i3d.py) share: a cache of a
module's folded weights that never goes stale, the dtype a module's eval forward
computes in, and when the fused cuDNN conv + ReLU calls apply."""

from __future__ import annotations

import weakref
from typing import Callable

import torch

_FUSED_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def fused_relu_ok(*tensors: torch.Tensor) -> bool:
    """Whether ``torch.cudnn_convolution_relu`` / ``cudnn_convolution_add_relu`` (one
    cuDNN call for conv + bias (+ residual) + ReLU) apply: CUDA tensors of a dtype cuDNN
    fuses (not float64: it has no engine for that), and no autograd graph to record (the
    fused calls have no backward)."""
    return (tensors[0].is_cuda and tensors[0].dtype in _FUSED_DTYPES
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)))


class FoldCache:
    """Folded eval weights of a module, made again whenever any of its parameters or
    buffers changes: the key is the caller's tag and each tensor's identity, storage and
    version counter, so an optimizer step, a ``load_state_dict`` or a move to another
    device all invalidate it, and no copy taken earlier is ever used. Nothing is kept
    while autograd records a graph through parameters that require grad: the folding is
    then part of the graph."""

    def __init__(self):
        self._entries: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    def get(self, module: torch.nn.Module, tag, make: Callable):
        tensors = [*module.parameters(), *module.buffers()]
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            return make()
        try:
            key = (tag, torch.is_inference_mode_enabled(),
                   tuple((id(t), t.data_ptr(), t._version) for t in tensors))
        except RuntimeError:  # an inference tensor has no version counter
            return make()
        hit = self._entries.get(module)
        if hit is None or hit[0] != key:
            hit = (key, make())
            self._entries[module] = hit
        return hit[1]


def compute_dtype(module: torch.nn.Module, device: torch.device) -> torch.dtype:
    """The dtype a module's eval forward computes in: the autocast dtype where autocast
    is on for ``device``, else the module's parameters'."""
    if torch.is_autocast_enabled(device.type):
        return torch.get_autocast_dtype(device.type)
    return next(module.parameters()).dtype
