"""The yardstick's arithmetic: the card's peaks, model FLOPs, and the bytes and
operations a kernel's call needs, all from shapes.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its 700 W limit (dense
rates, no sparsity). Model FLOPs are counted by ``torch.utils.flop_counter`` over the
benchmark's own float32 reference on meta tensors: the work of the model as written,
whatever kernels a version of the program runs it with. K1's bytes and K2's
operations follow each kernel's definition: every input byte the call needs read once
and every output byte written once; two FLOPs per multiply-add.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

BF16_FLOPS = 989e12  # dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12  # device memory rate


def count_flops(fn, *args) -> int:
    """FLOPs of ``fn(*args)`` as torch's FLOP counter counts them (convolutions and
    matrix products, two per multiply-add)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops())


def meta_params(weights: dict) -> dict:
    """The same names and shapes on the meta device, in float32."""
    return {k: torch.empty(v.shape, device="meta") for k, v in weights.items()}


def k1_bytes(clips_shape, crop_hw, out_hw, out_bytes: int) -> int:
    """Bytes one K1 call needs: the crop window of every frame read once (uint8 RGB)
    and every output frame written once."""
    b, t, _, _, c = clips_shape
    return b * t * c * (crop_hw[0] * crop_hw[1] + out_hw[0] * out_hw[1] * out_bytes)


def double_conv_flops(n: int, h: int, w: int, cin: int, cmid: int, cout: int) -> int:
    """Operations of one 3x3 DoubleConv over n frames of h x w (SAME padding)."""
    return 2 * n * h * w * 9 * (cin * cmid + cmid * cout)


def k2_flops_per_batch(double_convs, frames: int, h: int, w: int) -> int:
    """Operations of K2's launches for one batch of ``frames`` frames: the
    configuration's DoubleConvs, each [name, cin, cmid, cout, downscale]."""
    return sum(double_conv_flops(frames, h // s, w // s, cin, cmid, cout)
               for _, cin, cmid, cout, s in double_convs)
