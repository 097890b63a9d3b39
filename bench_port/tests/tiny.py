"""Tiny configurations and a tiny traffic mix for the CPU tests: the cells' shapes
shrunk so that a run on the CPU takes seconds."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

TINY_FT_SPECS = [[8, 1, 1, [1]], [16, 1, 2, [1]], [32, 1, 2, [1]], [64, 1, 2, [0]]]


def config(name: str) -> dict:
    """A cell's configuration at the port's tiny widths (the plain UNet keeps its own:
    it has no tiny variant), 64x64 frames, batches of 2 clips."""
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    if cfg["fa"]["arch"] == "unet++":
        cfg["fa"].update(decoder_channels=[16, 8, 8, 8], encoder_layers=[1, 1, 1, 1],
                         encoder_width=8)
    cfg["ft"].update(layer_specs=TINY_FT_SPECS, stem_width=8, feature_size=256)
    cfg["mgfn"].update(feature_size=256, dims=[16, 32, 64], depths=[1, 1, 1], dim_head=16)
    cfg["extraction"].update(reso_h=32, reso_w=32, batch_size=2, compute_dtype="float32")
    if "fb" in cfg:
        cfg["fb"].update(layers=[1, 1, 1, 1], width=8)
        cfg["anonymization"].update(batch_size=2, batch_size_vispr=4, vispr_canonical=40,
                                    num_frames=8, reso_h=32, reso_w=32, ori_reso_h=40,
                                    ori_reso_w=48, num_classes=5)
    return cfg


def traffic(name: str = "archive_240p") -> dict:
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        tr = json.load(f)
    if tr["kind"] == "adv_train":
        tr.update(raw_batches=3, negative_shift_frames=4, trace_start_s=0.0, trace_seconds=0.2)
        return tr
    tr.update(frame_h=40, frame_w=48, clips_min=1, clips_max=3, lengths_per_cycle=4,
              pool_frames=64, pool_scenes=2, pool_clips=16, sample_clips=64, sample_videos=4,
              trace_start_s=0.0, trace_seconds=0.5, warmup_batches=1,
              warmup_seconds=0.1)
    return tr
