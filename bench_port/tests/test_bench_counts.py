"""The yardstick's FLOP and byte counters against counts made by hand at small shapes."""

import json
import os

import pytest
import torch
import torch.nn.functional as F

from bench_port import counts
from bench_port.reference import models as ref

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_conv_and_matmul_flops():
    x = torch.empty(2, 3, 10, 12, device="meta")
    w = torch.empty(5, 3, 3, 3, device="meta")
    # Two FLOPs per multiply-add: N * Cout * Ho * Wo * Cin * k * k.
    assert counts.count_flops(F.conv2d, x, w, None, 1, 1) == 2 * 2 * 5 * 10 * 12 * 3 * 9
    a, b = torch.empty(7, 4, device="meta"), torch.empty(4, 6, device="meta")
    assert counts.count_flops(torch.matmul, a, b) == 2 * 7 * 4 * 6


def test_k1_bytes():
    # 2 clips of 3 frames, a 4x6 window of 8x10 RGB frames resized to 5x5 in bf16.
    assert counts.k1_bytes((2, 3, 8, 10, 3), (4, 6), (5, 5), 2) == 2 * 3 * 3 * (4 * 6 + 5 * 5 * 2)


def test_k1_bytes_serving_batch():
    """The serving batch's bound: 0.0343 ms at 3.35 TB/s, as the port's smoke computes."""
    crop = (ref.center_window(240, 0.8)[1], ref.center_window(320, 0.8)[1])
    assert crop == (192, 256)
    b = counts.k1_bytes((16, 16, 240, 320, 3), crop, (224, 224), 2)
    assert b == 256 * (192 * 256 * 3 + 224 * 224 * 3 * 2)
    assert b / counts.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0343, abs=5e-5)


def test_double_conv_flops():
    assert counts.double_conv_flops(1, 2, 3, 4, 5, 6) == 2 * 6 * 9 * (4 * 5 + 5 * 6)


def test_k2_flops_of_the_unet_batch():
    """The nine DoubleConvs of a 256-frame batch: 15.671 TFLOP, 15.845 ms at the bf16 peak."""
    with open(os.path.join(BENCH, "configs", "tedspad_unet_i3res50.json")) as f:
        cfg = json.load(f)
    flops = counts.k2_flops_per_batch(cfg["fa"]["double_convs"], 256, 224, 224)
    assert flops == 15_670_557_278_208
    assert flops / counts.BF16_FLOPS * 1e3 == pytest.approx(15.845, abs=1e-3)


def test_k2_flops_match_the_reference_unet():
    """K2's share of the reference UNet's FLOPs is its DoubleConvs'; the rest is outc."""
    with open(os.path.join(BENCH, "configs", "tedspad_unet_i3res50.json")) as f:
        cfg = json.load(f)
    from ted_spad_tpu_torch.models import UNet

    with torch.device("meta"):
        model = UNet(generator=torch.Generator())
    P = counts.meta_params(model.state_dict())
    total = counts.count_flops(ref.unet, torch.empty(2, 3, 32, 32, device="meta"), P)
    k2 = counts.k2_flops_per_batch(cfg["fa"]["double_convs"], 2, 32, 32)
    assert total - k2 == 2 * 2 * 32 * 32 * 64 * 3
