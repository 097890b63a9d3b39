#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ted_spad_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the port's CUDA kernels (csrc/preprocess.cu: K1, csrc/doubleconv.cu: K2,
     csrc/preprocess_yuv.cu: K3, csrc/int8conv.cu: K4) with nvcc, one process per
     source, started together;
  2. hold K1 against its plain PyTorch version on the card (chip_probes.K1_CASES: the
     serving shape, a ragged one, 480x856, 1080x1920, an unaligned base address and
     a runtime-taps shape) and time kernel (and its device-only reading), plain version
     and both library yardsticks (the cuBLAS matmul pair; F.interpolate antialiased,
     held against the plain version first), with the bytes/s achieved beside the bound
     and the registers;
  3. hold K2 against its plain version (float32 convs, TF32 off) at the plain UNet's
     nine DoubleConv shapes with a few frames, a ragged shape, the halo case and one
     ragged shape per bf16 tile class, in float32 and bfloat16; time it at the serving
     batch (256 frames) at those nine shapes and at four UNet++ decoder-cluster shapes,
     beside its plain version, its bound and the cuDNN conv pair, with each shape's
     tile class and that instantiation's registers (the bf16 ones must not spill);
  4. drive the default serving path at full model width: synthetic videos ->
     extract_features (K1 preprocess -> UNet++ fa -> I3Res50 ft, bf16) -> .npy -> UCF
     MGFN scores -> frame timeline, with the kernels' launch counts read from that
     run (K2: none);
  5. fidelity: the first batch again through the f32 plain path with TF32 off;
     every clip's feature cosine to it must reach FIDELITY_COS_MIN and the batch's
     error, against the spread between its clips, stay within FIDELITY_SPREAD_MAX,
     which two controls (a wrong preprocess with R and B swapped, another clip's
     features) must exceed, so the limit is shown to tell them apart;
  6. the same for the plain-UNet path (arch_fa="unet": K1 -> UNet whose nine
     DoubleConvs are K2 -> I3Res50 -> .npy -> MGFN), with K1 launched once and K2
     nine times per batch, and a second fidelity gate on the fa output itself;
  7. the serving CLI (python -m ted_spad_tpu_torch.score_video --synthetic) on its
     default device, with the default fa and with --params selecting the UNet;
  8. the MGFN anomaly stage at the UCF preset's full width (feature 2048, dims 64/128/
     1024, 16 videos per half, dropout 0.7, float32): synthetic 2048-d feature files
     with planted spans -> train_anomaly_detection for two epochs on the card (train
     steps, bucketed frame-AUC evaluation, best and final flax-msgpack checkpoints);
     one train step (dropout 0, weights moved off the seeded init) held against the
     same step on the CPU in float64, with another batch as the control, and the
     float32 step against it, with a TF32 step as the control; evaluate on the card against the CPU; the final checkpoint
     reloaded and scoring phase 4's features bit-equal to the in-memory model; the
     stage's times, checkpoint size and peak memory printed. It launches no kernel;
  9. the extraction stage's other configurations at full model width, each read for
     its kernel launches: XD-Violence serving (UNet++ fa, InceptionI3d ft ->
     extract_features -> 1024-d .npy -> XD-preset MGFN scores; K1 once per batch,
     bf16 features gated against the f32 plain path with both controls; step ms,
     clips/s, busy share, peak memory); ten-crop (ncrops=10 on UNet++ + I3Res50 ->
     (clips, 10, 2048) files scored by MGFN; K1's crops held against its plain version
     at the serving, 480x856 and a ragged frame, five crops at an odd address and the
     square window, and its ten windows timed beside the plain version and
     F.interpolate); no_ar_distortion (one batch, gated); quirk_compat (one batch in
     float32 on the card against the same step on the CPU, the unscrambled step as
     the control); r3d_18 and mvitv2 (one 16-clip batch each, gated, ms and clips/s);
 10. YUV420 serving at full width: K3 against its plain version (the serving batch with
     rows of all four colour sets, untagged rows, 480x856, an odd address, a small frame,
     the refusal of a chroma-misaligned window) and timed beside its bound, the plain
     version and per-plane F.interpolate + the colour matrix; synthetic videos ->
     extract_features(decode_mode="yuv") -> .npy -> MGFN scores with K3 once per batch
     and K1 never; the bf16 features gated against the f32 plain YUV path with both
     controls; step ms, clips/s, busy share;
 11. the int8 W8A8 serving mode (quant="int8", quant_calib_batches=2) at full width:
     extract_features with K4 79 times per int8 step (fa 27, ft 52) and K3 never; the
     features' cosine to bf16 >= INT8_COS_MIN; MGFN frame scores from int8 features
     within INT8_SCORE_ATOL of bf16 ones; the int8 step with K4 bit-equal to the same
     step with the plain int8 conv; the int8-vs-bf16 error over the between-clip spread
     beside its two controls; then K4 with its fused epilogue bit-equal to its plain
     version at all 79 conv shapes (batch cut), each with the epilogue form the step
     gives it (recorded by wrapping _Quantizer.conv), and at the ragged
     chip_probes.K4_CASES with every form of chip_probes.K4_FORMS; each of the 79 timed at
     its shape with its form beside its bound (the form's bytes), the plain version, the
     cuDNN bf16 conv and torch._int_mm + the epilogue's torch ops at the 1x1 shapes;
 12. training the models the serving path runs: one fa pretraining step (UNet++, 2 x
     224^2) and one action training step (I3Res50 with its head, 2 videos x 3 'trip'
     views of 16 x 112^2) on the card held against the CPU's float64 step from the same
     weights, batch and draw (TF32 off, dropout 0): the card's float64 step on the loss,
     every gradient and every BN statistic, its float32 step on the loss and statistics
     (its gradients printed), the card's float32 step on another batch the control; the
     full-width bf16 steps timed (UNet++ 32 x 224^2; I3Res50 16 videos x 3 views of
     16 x 224^2, 8 where 16 do not fit) with peak memory and a device profile; then
     train_reconstruction and anonymized train_action (through the fa just saved) for
     one short epoch each, their checkpoints reloaded bit-equal and served through the
     extraction step. No kernel launches on this path;
 13. the privacy side: the privacy step (ResNet50Classifier, 4 x 224^2 through the
     UNet++ fa), the adversarial fa step and fb/ft step (UNet++, ResNet50SSL, I3Res50
     with its head; 2 videos x 3 views x 16 x 112^2 + 4 VISPR pairs) on the card under
     remat "on" held against the CPU's float64 step under "off" from the same weights,
     batch and draw (TF32 off, dropout 0; loss, every gradient, every BN statistic;
     the card's float32 step beside it; the card's float32 step on another batch the control;
     no gradient on the fa step's frozen fb and ft); the full-width bf16 steps timed
     with peak memory and a device profile (privacy: 32 x 224^2; fa and fb/ft: 8
     videos x 3 views x 16 x 224^2 + 12 pairs under remat "auto" and "blocks", and 4
     videos under "auto", which resolves to no remat there); the privacy batch through
     the bf16 plain-UNet fa with K2 against its plain version; train_privacy (anon,
     plain-UNet fa: K2 9 times per fa forward) and train_anonymizer (plain-UNet fa: K2
     on the fb/ft step's, the preview's and the validation's fa forwards) for one short
     epoch each, their checkpoints reloaded bit-equal, the adversarial fa and ft served
     through the extraction step and its fb loaded as the SSL fb;
 14. the visualization stage (anonymize_video at its defaults, float32, chunks of 32) on a
     96-frame 240x320 synthetic video: the UNet++ fa (no kernel; its first frames held
     against the CPU's float32 stage within 1 level) and the plain UNet, whose nine
     DoubleConvs run K2's float32 form (27 launches; frames held against the same stage
     through the plain DoubleConv within 1 level and a share of 1e-3), then in bf16 (K2's
     bf16 form, 27 launches, held to the fa-fidelity limit against the float32 plain
     frames), each gate with two controls that must exceed it; ms per frame, frames/s,
     peak memory and the writer (mp4 through the native encoder, or y4m without it);
     the grid PNG read back, the mp4 decoded against it; the CLI
     (python -m ted_spad_tpu_torch.visualize_anonymization --synthetic); K2's float32
     form timed at one chunk's nine DoubleConvs beside its plain version, the cuDNN
     float32 pairs (TF32 off) and its bound;
 15. the InceptionI3d, R3D-18 and MViTv2-S fts in training: per family, one action step
     ('trip', 'ce') and one adversarial fa step and fb/ft step (card remat "on") on the
     card in float64 held against a float64 reference step (remat "off") from the same
     weights, batch and draw (TF32 off, dropout 0; phase 12's limits; the card's float32
     loss beside it; the card's float32 step on another batch the control); the full-width
     bf16 steps at ActionParams' and AnonymizationParams' defaults timed, each batch
     halved while it does not fit; train_action with r3d_18 and train_anonymizer with the
     i3d ft (UNet++ fa: no kernel) for one epoch of 2 steps, checkpoints reloading
     bit-equal. Each family's action step is held against the CPU's float64 step; its
     fa and fb/ft steps (remat "on") against the card's own float64 step under remat
     "off", the controls on the card;
 16. data parallel (ted_spad_tpu_torch/parallel): DP_WORLD gloo ranks on cuda:0, each its
     own process (this file with --dp-rank), run the MGFN step at the UCF preset, the
     I3Res50 action step and the adversarial fa step (accum_steps 2) and fb/ft step at
     full model width, sharded; each rank's float64 step is held against the one-process
     card step (losses, every gradient, the state after Adam, within DP_RTOL of each
     tensor's largest value), the float32 readings printed beside the one-process float32
     step's; step times and the collectives' share; each rank's K1 and K2 launches on
     extract_features(mesh=) with the UNet++ and the plain-UNet fa and on
     train_anonymizer(mesh=) with the plain UNet (one epoch of 2 steps); then a group of
     one over NCCL runs train_anonymizer(mesh=) for one step.

Prints the kernel table as one JSON line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Exits non-zero, printing no result,
without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate

SERVING_VIDEOS, SERVING_FRAMES = 6, 320  # 240x320 synthetic videos, 10 clips each
FEATURE_DIM = 2048  # I3Res50 pooled feature
# Features of the bf16 serving path vs the f32 plain path. Random-init features of
# different inputs are near-collinear, so the per-clip cosine cannot tell a wrong
# preprocess apart (R/B swapped reads 0.99995 against 0.999995 on an H100); the
# error over the batch, measured against the spread between its clips, can.
FIDELITY_COS_MIN = 0.99
FIDELITY_SPREAD_MAX = 0.5

K2_CHECK_FRAMES = 2
K2_TIMED_FRAMES = 256  # one 16-clip batch of 16 frames: one launch per DoubleConv
# K2 vs its plain version. f32: summation order only. bf16: 2**-6 of max|ref| is one
# to two bf16 ulps at the largest value: summation order, and with it an occasional
# flip in the rounding of a conv1 value (kept in bf16 between the convs) or an output.
K2_F32_TOL = 1e-4
K2_BF16_TOL = 2.0 ** -6
UNET_VIDEOS = 2  # 240x320 synthetic videos of SERVING_FRAMES frames, 10 clips each
# The random-init UNet's sigmoid output sits near 0.5 (std 0.029, between-frame spread
# RMS 0.011 on an H100): the ft's own bf16 rounding then swamps the differences
# between clips (features' error / spread 1.09 with K2 exact). A trained anonymizer's
# output resembles its input, so the smoke draws outc 8x wider: output std 0.21, no
# saturation, error / spread 0.17 (python -m ted_spad_tpu_torch.chip_probes gain
# sweeps gains 1/4/8/16).
UNET_OUTC_GAIN = 8.0

# Phase 9: the other extraction configurations.
XD_VIDEOS = 4  # 240x320 synthetic videos of SERVING_FRAMES frames, 10 clips each
TEN_CROP_BATCH = 4  # clips per step: 4 x 10 crops x 16 frames = 640 UNet++ frames
QUIRK_CLIPS = 2  # the CPU's float32 step through the full-width UNet++ and I3Res50 is the cost
# quirk_compat, card float32 step vs the CPU's: ||card - cpu|| / ||cpu||. The card's step
# without the scramble (the control) must exceed it.
QUIRK_RTOL = 1e-3
OPTION_FEATURES = {"i3d": 1024, "r3d_18": 512, "mvitv2": 768}

# Phases 10 and 11: YUV ingest and the int8 serving mode.
YUV_VIDEOS = 4  # 240x320 synthetic videos of SERVING_FRAMES frames, 10 clips each
INT8_VIDEOS = 4
INT8_CONVS = 79  # per step: fa 14 encoder + 6 skip + 7 decoder conv2; ft 16 x 3 + 4 downsamples
INT8_COS_MIN = 0.99  # quant_feature_cossim_vs_bf16
INT8_SCORE_ATOL = 0.05  # MGFN frame scores, int8 vs bf16 features (tests/test_quant_i3d.py:134)

# Phase 8: the anomaly stage's data, cut from UCF-Crime's 1,610 training and 290 test
# videos; 3 steps per epoch at 16 videos per half.
ANOMALY_TRAIN_VIDEOS, ANOMALY_TEST_VIDEOS = 96, 24  # the first half of the training list abnormal
ANOMALY_CLIPS = (40, 241)  # clips per video, drawn uniformly
ANOMALY_EPOCHS = 2
# Card step vs CPU step from the same weights and batch, both in float64 (TF32 off).
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_STATS_RTOL = 1e-5, 1e-4, 1e-5
# The card's float32 step vs the CPU's float64 one: loss and each gradient tensor.
# float32 reads up to 1.4e-4 (PERF.md §6, the MGFN stage); TF32 must read above it (the control).
STEP_F32_RTOL = 1e-3
EVAL_AUC_ATOL = 1e-4

# Phase 12: training. Full-width steps at the stages' default batches (UNet++ fa: 32
# images of 224^2; I3Res50 ft with its 102-class head: 16 videos x 3 'trip' views of
# 16 x 224^2, FrozenBN, dropout 0.5), bf16 under autocast; 8 videos where 16 do not fit.
TRAIN_FA_BATCH = 32
TRAIN_FT_BATCHES = (16, 8)
TRAIN_TIMED_STEPS = 5
# Card step vs the CPU's float64 step from the same weights, batch and draw, TF32 off,
# dropout 0: the loss, each gradient tensor and each BN running statistic
# (||card - cpu|| / ||cpu||). The card's float64 step is held to all three, its float32
# step to the loss and the statistics; its float32 gradients are printed: train-mode
# BN's fast variance and L1's sign put 2e-3 (ft) to 4e-3 (fa) between the card's
# float32 gradients and float64 ones on an H100 (PERF.md §6, the training stages; the
# CPU's own float32 step reads 6.8e-4 and 6.0e-3). The card's float32 step on another
# batch (the control) must exceed each limit.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_STATS_RTOL = 1e-4, 1e-3, 1e-4
TRAIN_GATE_FA = (2, 224)  # images, side
TRAIN_GATE_FT = (2, 112)  # videos (x 3 views of 16 frames), side
# A gradient that is zero in exact arithmetic (the MLP head's fc1 bias, which its
# train-mode BN removes) is rounding noise on both sides: held absolutely, below this
# share of the largest gradient, on both.
TRAIN_NULL_GRAD = 1e-5
TRAIN_DRIVER_STEPS = 2  # steps in each stage driver's one epoch

# Phase 13: the privacy side. The gate: card against CPU, the card's step under
# remat "on", the CPU's under "off", TF32 off, dropout 0, phase 12's float64 limits
# (TRAIN_*_RTOL; the card's float32 step on the loss): the privacy step (ResNet50Classifier, 7 attributes, 4 images of 224^2
# through the UNet++ fa), the fa step and the fb/ft step (UNet++, ResNet50SSL, I3Res50
# with its head; 2 videos x 3 views x 16 x 112^2 and 4 VISPR pairs of 112^2).
PRIV_GATE = (4, 224)  # images, side
ADV_GATE = (2, 4, 112)  # videos (x 3 views of 16 frames), VISPR pairs, side
# Full-width bf16 steps timed (1 warm-up, ADV_TIMED_STEPS timed): the privacy step at
# PrivacyParams' batch (32 images of 224^2, through the bf16 UNet++ fa), and the fa and
# fb/ft steps at AnonymizationParams' (8 videos x 3 views x 16 x 224^2 + 12 VISPR pairs)
# under remat "auto" (full remat at this size) and "blocks", and at 4 videos + 12 pairs
# under "auto" (no remat: below REMAT_AUTO_PIXELS).
ADV_TIMED_STEPS = 3
ADV_TIMED = (("auto", 8), ("blocks", 8), ("auto", 4))  # (remat, videos)
# The stage drivers: train_privacy (anon through the plain-UNet fa, K2) for one epoch of
# 2 steps of 32 images and 1 validation batch; train_anonymizer (plain-UNet fa) for one
# epoch of 4 batches (2 fa steps, 2 fb/ft steps) of 2 videos and 4 VISPR pairs at 224^2.
ADV_DRIVER = (2, 4)  # videos, VISPR pairs per batch

# Phase 14: the visualization stage at its defaults (float32, chunks of 32 frames of
# 240x320) on one synthetic video of three chunks. Gates on the anonymized uint8 frames:
# at most VIS_LEVEL_TOL level apart (K2 against the plain DoubleConv: also at most
# VIS_DIFF_SHARE of the values differ), each with controls that must exceed it; the
# decoded mp4 within VIS_MP4_MEAN mean levels of the grid (tests/test_visualization_stage.py:33).
VIS_FRAMES, VIS_CHUNK_FRAMES = 96, 32
VIS_VIDEO = f"synthetic://n={VIS_FRAMES},h=240,w=320,seed=3"
VIS_CPU_FRAMES = 2  # UNet++ frames held against the CPU's float32 run (next two: a control)
VIS_LEVEL_TOL = 1
VIS_DIFF_SHARE = 1e-3
VIS_MP4_MEAN = 16
F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores (CUDA-core FMAs)

# Phase 15: the other ft families in training. The gate (card float64 against the CPU's
# float64 step, TF32 off, dropout 0, phase 12's limits): videos x 3 views and the clip
# (T, H, W) of each family: i3d at its smallest clip, r3d_18 at 112^2, mvitv2 at the
# smallest clip its full-width model and the UNet++ fa take; FT_GATE_PAIRS VISPR pairs.
FT_FAMILIES = ("i3d", "r3d_18", "mvitv2")
FT_GATE = {"i3d": (1, (9, 193, 193)), "r3d_18": (2, (8, 112, 112)), "mvitv2": (2, (2, 16, 16))}
FT_GATE_PAIRS = 4
FT_TIMED_STEPS = 2
FT_DRIVER_STEPS = 2  # batches in each driver's one epoch

# Phase 16: data parallel. DP_WORLD gloo ranks on cuda:0 (NCCL refuses two ranks on one
# card; a group of one shows NCCL) run four steps sharded at full model width, batches
# cut to what the ranks share: MGFN at the UCF preset with DP_MGFN_BATCH videos per
# half; the I3Res50 action step ('trip', 'ce'); the adversarial fa step under
# accum_steps DP_ACCUM and the fb/ft step. Each rank's float64 step is held against the
# one-process card step to DP_RTOL of each tensor's largest value (summation order
# only). Ranks sharing one card show no scaling: their times are a reading.
DP_WORLD = 2
DP_DEVICE = "cuda:0"  # every rank on the one card
DP_MGFN_BATCH = 16
DP_ACTION = (4, 16, 112)  # videos (x 3 views), frames, side
DP_ADV = (4, 4, 16, 112)  # videos (x 3 views), VISPR pairs, frames, side
DP_ACCUM = 2
DP_RTOL = 1e-9
DP_NULL_GRAD = 1e-6  # of the step's largest gradient: rounding noise (_dp_worst)
DP_TIMED_STEPS = 2
DP_EXTRACT_VIDEOS, DP_EXTRACT_BATCH = 4, 16  # synthetic serving videos (10 clips each), clips per step
DP_DRIVER = (2, 4)  # videos, VISPR pairs per batch of the data-parallel drivers
DP_RANK_TIMEOUT_S = 600


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_build() -> tuple[dict, dict]:
    """nvcc for every kernel source at once (one process each), then each one's
    ptxas lines: registers, spills, shared memory. Returns K1's and K2's registers and
    spills by instantiation, and fails if a bf16 K2 one spills (K3's and K4's are
    logged)."""
    from concurrent.futures import ThreadPoolExecutor

    from ted_spad_tpu_torch.chip_probes import k1_register_report, k2_register_report
    from ted_spad_tpu_torch.utils import cuda_build

    names = ("preprocess", "doubleconv", "preprocess_yuv", "int8conv")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        results = list(pool.map(cuda_build.build, names))
    for name, (seconds, nvcc_out) in zip(names, results):
        for line in nvcc_out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")
        log(f"[build] csrc/{name}.cu built in {seconds:.2f}s")
    log(f"[build] all kernels built in {time.perf_counter() - t0:.2f}s")
    out = dict(zip(names, results))
    return k1_register_report(out["preprocess"][1], log), k2_register_report(out["doubleconv"][1], log)


def check_preprocess(device, registers: dict) -> dict:
    """K1 against fused_preprocess_reference (TF32 off) at every chip_probes.K1_CASES
    shape, f32 and bf16 out, then its time at the serving shape beside its bound, the
    plain version and both library yardsticks. ``registers``: K1's ptxas report by
    instantiation (phase_build)."""
    from ted_spad_tpu_torch.chip_probes import k1_check, k1_timing

    worst = k1_check(device, log)
    entry = k1_timing(device, log)
    entry["registers"] = registers[f"bf16 {entry['kernel']}"]["registers"]
    log(f"[K1] {entry['kernel']} (bf16): {entry['registers']} registers; "
        f"{entry['library_ms'] / entry['ms']:.2f}x faster than the cuBLAS pair, "
        f"{entry['library_interpolate_ms'] / entry['ms']:.2f}x faster than F.interpolate")
    return {**entry, "max_abs_err": worst}


def double_conv_bound(n, h, w, cin, cmid, cout) -> tuple[float, float]:
    """(ms by operations, ms by bytes) of one bf16 DoubleConv: 2*9*(Cin*Cmid +
    Cmid*Cout) FLOP per pixel at the bf16 tensor-core peak; x read and the output
    written once, the weights and f32 biases read once, at the memory rate."""
    flops = 2 * n * h * w * 9 * (cin * cmid + cmid * cout)
    bytes_moved = 2 * (n * h * w * (cin + cout) + 9 * (cin * cmid + cmid * cout)) + 4 * (cmid + cout)
    return flops / BF16_FLOPS * 1e3, bytes_moved / HBM_BYTES_PER_S * 1e3


def check_double_conv(device, registers: dict) -> dict:
    """K2 against double_conv_reference (float32 convs, TF32 off) at every UNet shape
    and the hard cases, then its times at the serving batch. ``registers``: K2's
    ptxas report by instantiation (phase_build)."""
    import torch

    from ted_spad_tpu_torch.chip_probes import (
        K2_CLASS_RAGGED, UNET_DOUBLECONVS, UNETPP_CLUSTER, double_conv_operands,
    )
    from ted_spad_tpu_torch.ops import doubleconv as dc
    from ted_spad_tpu_torch.utils.device import tf32_off

    cases = [(name, (K2_CHECK_FRAMES, s, s, ci, cm, co), None)
             for name, s, ci, cm, co in UNET_DOUBLECONVS]
    cases += [("ragged", (2, 13, 17, 24, 16, 8), None), ("halo b1=5", (1, 28, 28, 16, 8, 8), 5.0)]
    cases += [(name, shape, None) for name, shape in K2_CLASS_RAGGED]
    worst = 0.0
    for i, (name, shape, b1) in enumerate(cases):
        for dtype, tol in ((torch.float32, K2_F32_TOL), (torch.bfloat16, K2_BF16_TOL)):
            args = double_conv_operands(device, shape, dtype, seed=i, b1=b1)
            got = dc.fused_double_conv(*args)
            with tf32_off():
                ref = dc.double_conv_reference(*args)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            log(f"[K2] {name} {shape} {str(dtype)[6:]}: max|kernel - plain| = {err:.3e}, "
                f"{err / scale:.3e} of max|plain| {scale:.3f} (tolerance {tol:.3e})")
            if not (scale > 0 and err <= tol * scale):
                raise AssertionError(f"K2 disagrees with its plain version at {name}: {err}")
            worst = max(worst, err)

    shapes = []
    for where, table in (("unet", UNET_DOUBLECONVS), ("unet++ decoder", UNETPP_CLUSTER)):
        for name, s, ci, cm, co in table:
            shape = (K2_TIMED_FRAMES, s, s, ci, cm, co)
            ms, plain_ms, library_ms = _k2_times(
                *double_conv_operands(device, shape, torch.bfloat16, seed=99))
            by_ops, by_bytes = double_conv_bound(*shape)
            bound_ms = max(by_ops, by_bytes)
            flops = by_ops * 1e-3 * BF16_FLOPS
            plan = dc.k2_tile_plan(s, s, ci, cm, co)
            shapes.append({"path": where, "block": name, "shape": [s, s, ci, cm, co],
                           "frames": K2_TIMED_FRAMES, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": "operations" if by_ops >= by_bytes
                           else "bytes", "library_ms": library_ms, "tile_class": plan.tile_class,
                           "registers": registers[plan.kernel]["registers"]})
            log(f"[K2] {where} {name} {s}x{s} {ci}->{cm}->{co} x{K2_TIMED_FRAMES} bf16, tile "
                f"{plan.tile_class} ({plan.kernel}, {shapes[-1]['registers']} registers): kernel "
                f"{ms:.4f} ms ({flops / ms * 1e-9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, cuDNN pair "
                f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({shapes[-1]['bound_by']}; "
                f"bytes {by_bytes:.4f} ms), {ms / bound_ms:.1f}x the bound, "
                f"{ms / library_ms:.2f}x cuDNN, {plain_ms / ms:.2f}x faster than plain")
    unet = [r for r in shapes if r["path"] == "unet"]
    by_ops, by_bytes = (sum(t) for t in zip(*(double_conv_bound(K2_TIMED_FRAMES, *r["shape"])
                                              for r in unet)))
    total = {key: sum(r[key] for r in unet) for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    log(f"[K2] the nine UNet DoubleConvs of one 16-clip batch: kernel {total['ms']:.3f} ms, plain "
        f"{total['plain_ms']:.3f} ms, cuDNN pairs {total['library_ms']:.3f} ms, bound "
        f"{total['bound_ms']:.3f} ms")
    return {
        "name": "K2 double_conv", "route": "cuda",
        "source": "ted_spad_tpu_torch/csrc/doubleconv.cu",
        "replaces": "ted_spad_tpu/ops/pallas_doubleconv.py:46",
        "max_abs_err": worst, **total,
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "shapes": shapes,
    }


def _k2_times(x, w1, b1, w2, b2) -> tuple[float, float, float]:
    """ms of K2, of its plain version and of the yardstick, cuDNN's channels_last conv +
    bias + ReLU twice on the same folded weights in x's dtype (the port never calls it),
    on these operands; the last two with TF32 off."""
    import torch
    import torch.nn.functional as F

    from ted_spad_tpu_torch.chip_probes import time_ms
    from ted_spad_tpu_torch.ops import doubleconv as dc
    from ted_spad_tpu_torch.utils.device import tf32_off

    ms = time_ms(lambda: dc.fused_double_conv(x, w1, b1, w2, b2), reps=3, inner=1)
    xc = x.permute(0, 3, 1, 2)
    w1c, w2c = (t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) for t in (w1, w2))
    b1c, b2c = b1.to(x.dtype), b2.to(x.dtype)
    with tf32_off():
        plain_ms = time_ms(lambda: dc.double_conv_reference(x, w1, b1, w2, b2), reps=3, inner=1)
        library_ms = time_ms(lambda: F.relu(F.conv2d(F.relu(F.conv2d(xc, w1c, b1c, padding=1)), w2c, b2c,
                                                     padding=1)), reps=3, inner=1)
    return ms, plain_ms, library_ms


def profile_step(fn, steps: int) -> None:
    """Device time by kernel over ``steps`` calls (torch.profiler), and the device's
    busy share of the window's host wall time."""
    from ted_spad_tpu_torch.chip_probes import device_profile

    prof = device_profile(fn, steps)
    log(f"[profile] {steps} steps: device time {prof['device_ms']:.3f} ms/step, busy "
        f"{prof['busy']:.3f} of the host window ({prof['wall_ms']:.3f} ms/step, profiler on)")
    for name, ms in prof["kernels"][:12]:
        log(f"[profile]   {ms:8.3f} ms/step {ms / prof['device_ms']:6.3f}  {name[:90]}")


def _kernel_wrappers() -> dict:
    from ted_spad_tpu_torch.ops.doubleconv import fused_double_conv
    from ted_spad_tpu_torch.ops.int8conv import int8_conv
    from ted_spad_tpu_torch.ops.preprocess import fused_preprocess
    from ted_spad_tpu_torch.ops.yuv import fused_preprocess_yuv

    return {"K1 preprocess": fused_preprocess, "K2 double_conv": fused_double_conv,
            "K3 preprocess_yuv": fused_preprocess_yuv, "K4 int8_conv": int8_conv}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


def zero_launch_counts() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def expected(K1: int = 0, K2: int = 0, K3: int = 0, K4: int = 0) -> dict:  # noqa: N803
    """Launch counts of the four kernels, the ones not given 0."""
    return dict(zip(_kernel_wrappers(), (K1, K2, K3, K4)))


def first_batch(uris: list, p, device, decode_mode: str = "rgb"):
    import torch

    from ted_spad_tpu_torch.stages.feature_extraction import iter_clip_batches

    batch, _, _ = next(iter_clip_batches(uris, p, p.batch_size, num_workers=8,
                                         decode_mode=decode_mode))
    return torch.from_numpy(batch).to(device)


def serving_path(device, workdir: str) -> dict:
    """Drive the port's serving path at full width, the way a user would, and check
    its outputs. Returns the kernels' launch counts from this run."""
    import torch

    from ted_spad_tpu_torch.chip_probes import conv_class, record_int8_convs, time_ms
    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
    from ted_spad_tpu_torch.stages.feature_extraction import (
        extract_features, make_extract_step, video_clip_starts,
    )

    p = FeatureExtractionParams(batch_size=16)  # the default serving configuration, bf16
    uris = [f"synthetic://n={SERVING_FRAMES},h=240,w=320,seed={i}" for i in range(SERVING_VIDEOS)]
    clips_per_video = len(video_clip_starts(SERVING_FRAMES, p.num_frames, p.clip_stride,
                                            p.clip_step))
    fa = load_fa_model(seed=0, device=device)
    ft = load_ft_model(seed=0, device=device)
    log(f"[serve] UNet++ fa {sum(x.numel() for x in fa.parameters())} params, I3Res50 ft "
        f"{sum(x.numel() for x in ft.parameters())} params, {p.compute_dtype}, "
        f"{len(uris)} videos x {clips_per_video} clips, batch {p.batch_size}")

    torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    res = extract_features(p, uris, os.path.join(workdir, "features"), fa=fa, ft=ft,
                           decode_hw=(240, 320), num_workers=8, device=device, log_fn=log)
    peak = torch.cuda.max_memory_allocated(device)
    log(f"[serve] extract_features: {res['clips']} clips in {res['elapsed_s']:.3f}s = "
        f"{res['clips_per_sec']:.2f} clips/s end to end (decode included), peak device memory "
        f"{peak / 2**20:.1f} MiB")
    if len(res["saved"]) != len(uris) or res["skipped"]:
        raise AssertionError(f"expected {len(uris)} .npy files, got {res}")

    score_videos(res["saved"], (clips_per_video, FEATURE_DIM), p.clip_step, device, "[serve]")

    launches = launch_counts()  # the main path ends here
    log(f"[serve] kernel launches on the main path: {json.dumps(launches)}")
    if launches["K1 preprocess"] <= 0:
        raise AssertionError("the serving path never launched K1")
    if launches != expected(K1=launches["K1 preprocess"]):
        raise AssertionError(f"the UNet++ path launched K2, K3 or K4: {launches}")

    # Device time of one extraction step at the serving batch (decode excluded).
    batch = first_batch(uris, p, device)
    step = make_extract_step(ft, p, fa, device=device)
    step_ms = time_ms(lambda: step(batch), reps=5, inner=2)
    log(f"[serve] extract step device time {step_ms:.3f} ms per {p.batch_size}-clip batch = "
        f"{p.batch_size / step_ms * 1e3:.2f} clips/s")
    profile_step(lambda: step(batch), steps=3)

    # Phase 5: the first batch through the float32 plain path, TF32 off.
    fa32 = load_fa_model(seed=0, dtype="float32", device=device)
    ft32 = load_ft_model(seed=0, dtype="float32", device=device)
    ref_step = make_extract_step(ft32, p.replace(compute_dtype="float32"), fa32,
                                 use_kernel=False, device=device)
    got = step(batch).double()
    ref = ref_step(batch).double()
    feature_gate(got, ref, step(batch.flip(-1).contiguous()).double(), "[fidelity]")
    return launches


def score_videos(saved: dict, shape: tuple, clip_step: int, device, tag: str,
                 dataset: str = "UCF") -> None:
    """Every video's .npy -> ``dataset``'s MGFN clip scores -> frame timeline, checked:
    finite features of ``shape`` ((clips, F) or (clips, ncrops, F)), SERVING_FRAMES
    frame scores in [0, 1]."""
    import numpy as np

    from ted_spad_tpu_torch.config.params import MGFNParams
    from ted_spad_tpu_torch.data.features import padded_test_batch
    from ted_spad_tpu_torch.models import load_mgfn_model
    from ted_spad_tpu_torch.ops.metrics import frame_level_scores
    from ted_spad_tpu_torch.ops.temporal import test_features as with_magnitude
    from ted_spad_tpu_torch.stages.anomaly_detection import make_score_fn

    mgfn = load_mgfn_model(MGFNParams.for_dataset(dataset), device=device)
    score_fn = make_score_fn(mgfn, device=device)
    latencies = []
    for uri, path in saved.items():
        feats = np.load(path)
        if feats.shape != tuple(shape) or not np.isfinite(feats).all():
            raise AssertionError(f"{path}: features {feats.shape}, finite={np.isfinite(feats).all()}")
        t0 = time.perf_counter()
        video, mask, t = padded_test_batch(with_magnitude(feats))
        clip_scores = score_fn(video, mask)[0, :t].cpu().numpy()
        frames = frame_level_scores(clip_scores, SERVING_FRAMES, frames_per_clip=clip_step)
        latencies.append(time.perf_counter() - t0)
        if frames.shape != (SERVING_FRAMES,) or not ((frames >= 0) & (frames <= 1)).all():
            raise AssertionError(f"{uri}: frame scores {frames.shape} outside [0, 1]")
    log(f"{tag} MGFN {dataset} scoring of {tuple(shape)} features: {len(latencies)} videos, latency per video "
        f"{json.dumps([round(x * 1e3, 3) for x in latencies])} ms (first includes warm-up), "
        f"scores in [0, 1]")


def feature_gate(got, ref, swapped, tag: str) -> None:
    """The bf16 features of one batch against the f32 plain path's. Controls: a wrong
    preprocess (R and B swapped) and another clip's features, read against the same
    f32 reference, must exceed the limit."""
    readings = {name: fidelity(x, ref) for name, x in (
        ("serving", got),
        ("control R/B swapped", swapped),
        ("control previous clip", got.roll(1, dims=0)),
    )}
    for name, (cos_min, spread_err) in readings.items():
        log(f"{tag} {name} vs f32 plain path (TF32 off), {got.shape[0]} clips: min cosine "
            f"{cos_min:.8f} (limit {FIDELITY_COS_MIN}), error / between-clip spread "
            f"{spread_err:.6f} (limit {FIDELITY_SPREAD_MAX})")
    cos_min, spread_err = readings.pop("serving")
    if not (cos_min >= FIDELITY_COS_MIN and spread_err <= FIDELITY_SPREAD_MAX):
        raise AssertionError(f"features drift from the f32 path: {cos_min}, {spread_err}")
    for name, (_, control_err) in readings.items():
        if not control_err > FIDELITY_SPREAD_MAX:
            raise AssertionError(f"the fidelity limit does not reject the {name}")


def unet_path(device, workdir: str) -> dict:
    """The plain-UNet serving path (arch_fa="unet") at full width through the user's
    entry point, extract_features. Checks its outputs and kernel launch counts (K1
    once, K2 nine times per batch), times its step, and holds its features and its fa
    output against the f32 plain path."""
    import torch

    from ted_spad_tpu_torch.chip_probes import conv_class, record_int8_convs, time_ms
    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
    from ted_spad_tpu_torch.ops.preprocess import fused_preprocess_reference
    from ted_spad_tpu_torch.stages.feature_extraction import (
        extract_features, make_extract_step, video_clip_starts,
    )
    from ted_spad_tpu_torch.utils.device import tf32_off

    p = FeatureExtractionParams(batch_size=16, arch_fa="unet")
    uris = [f"synthetic://n={SERVING_FRAMES},h=240,w=320,seed={100 + i}"
            for i in range(UNET_VIDEOS)]
    clips_per_video = len(video_clip_starts(SERVING_FRAMES, p.num_frames, p.clip_stride,
                                            p.clip_step))

    def unet(dtype: str):
        fa = load_fa_model(p.arch_fa, seed=0, dtype=dtype, device=device)
        with torch.no_grad():
            fa.outc.weight.mul_(UNET_OUTC_GAIN)
        return fa

    fa = unet(p.compute_dtype)
    ft = load_ft_model(seed=0, device=device)
    log(f"[unet] UNet fa {sum(x.numel() for x in fa.parameters())} params (outc x"
        f"{UNET_OUTC_GAIN}), {p.compute_dtype}, {len(uris)} videos x {clips_per_video} clips, "
        f"batch {p.batch_size}")

    torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    res = extract_features(p, uris, os.path.join(workdir, "features_unet"), fa=fa, ft=ft,
                           decode_hw=(240, 320), num_workers=8, device=device, log_fn=log)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    batches = -(-res["clips"] // p.batch_size)
    log(f"[unet] extract_features: {res['clips']} clips in {res['elapsed_s']:.3f}s = "
        f"{res['clips_per_sec']:.2f} clips/s end to end (decode included), peak device memory "
        f"{peak / 2**20:.1f} MiB")
    log(f"[unet] kernel launches on the UNet path: {json.dumps(launches)} for {batches} batches")
    if len(res["saved"]) != len(uris) or res["skipped"]:
        raise AssertionError(f"expected {len(uris)} .npy files, got {res}")
    if launches != expected(K1=batches, K2=9 * batches):
        raise AssertionError(f"expected K1 x{batches} and K2 x{9 * batches}: {launches}")
    score_videos(res["saved"], (clips_per_video, FEATURE_DIM), p.clip_step, device, "[unet]")

    batch = first_batch(uris, p, device)
    step = make_extract_step(ft, p, fa, device=device)
    step_ms = time_ms(lambda: step(batch), reps=3, inner=1)
    log(f"[unet] extract step device time {step_ms:.3f} ms per {p.batch_size}-clip batch = "
        f"{p.batch_size / step_ms * 1e3:.2f} clips/s")
    profile_step(lambda: step(batch), steps=2)

    fa32 = unet("float32")
    ft32 = load_ft_model(seed=0, dtype="float32", device=device)
    ref_step = make_extract_step(ft32, p.replace(compute_dtype="float32"), fa32,
                                 use_kernel=False, device=device)
    got = step(batch).double()
    feature_gate(got, ref_step(batch).double(), step(batch.flip(-1).contiguous()).double(),
                 "[unet fidelity]")

    # The fa output itself: the bf16 UNet with K2 against the f32 plain UNet, on the
    # batch's frames from the f32 plain preprocess.
    b, t = batch.shape[:2]
    img = fused_preprocess_reference(batch, out_dtype=torch.float32)
    frames = img.reshape((b * t,) + img.shape[2:]).permute(0, 3, 1, 2)
    with torch.inference_mode(), tf32_off():
        ref = fa32(frames, use_kernel=False).double()
        out = fa(frames).double()
        swapped = fa(frames.flip(1)).double()
    spread = torch.linalg.norm(ref - ref.mean(0))
    readings = {"fa bf16 K2": out, "control R/B swapped": swapped,
                "control previous clip": out.roll(t, dims=0)}
    log(f"[unet fidelity] fa output (f32 plain): mean {float(ref.mean()):.6f}, std "
        f"{float(ref.std()):.6f}, min {float(ref.min()):.6f}, max {float(ref.max()):.6f}, "
        f"share saturated (< 0.01 or > 0.99) {float(((ref < 0.01) | (ref > 0.99)).double().mean()):.6f}, "
        f"between-frame spread (RMS) {float(spread) / ref.numel() ** 0.5:.6f}")
    errs = {}
    for name, x in readings.items():
        errs[name] = float(torch.linalg.norm(x - ref) / spread)
        log(f"[unet fidelity] {name} vs f32 plain fa (TF32 off), {b * t} frames: error / "
            f"between-frame spread {errs[name]:.6f} (limit {FIDELITY_SPREAD_MAX}), max abs "
            f"error {float((x - ref).abs().max()):.6f}")
    if not errs.pop("fa bf16 K2") <= FIDELITY_SPREAD_MAX:
        raise AssertionError("the bf16 K2 UNet drifts from the f32 plain UNet")
    for name, err in errs.items():
        if not err > FIDELITY_SPREAD_MAX:
            raise AssertionError(f"the fa fidelity limit does not reject the {name}")
    return launches


def fidelity(x, ref) -> tuple[float, float]:
    """(min per-clip cosine, ||x - ref|| / ||ref - mean clip of ref||) over a batch of
    features: the second reads the error against how much the clips differ."""
    import torch

    cos = torch.nn.functional.cosine_similarity(x, ref, dim=1)
    return float(cos.min()), float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref - ref.mean(0)))


def serving_cli(workdir: str) -> None:
    """The serving CLI's synthetic smoke on its default device (cuda), with the
    default fa and with a --params file selecting the plain UNet (K2 at 32^2 ... 2^2)."""
    import contextlib
    import io

    from ted_spad_tpu_torch import score_video
    from ted_spad_tpu_torch.ops.doubleconv import fused_double_conv

    params = os.path.join(workdir, "params_unet.py")
    with open(params, "w") as f:
        f.write('arch_fa = "unet"\n')
    for extra in ([], ["--params", params]):
        out = io.StringIO()  # its per-video JSON lines stay off this script's stdout
        launches = fused_double_conv.launches
        with contextlib.redirect_stdout(out):
            summaries = score_video.run(score_video.parser().parse_args(
                ["--synthetic", "--out_dir", os.path.join(workdir, "cli"), *extra]))
        if len(summaries) != 2 or any("error" in s for s in summaries):
            raise AssertionError(f"score_video --synthetic {extra}: {summaries}")
        if (fused_double_conv.launches > launches) != bool(extra):
            raise AssertionError(f"score_video --synthetic {extra}: K2 launched "
                                 f"{fused_double_conv.launches - launches} times")
        log(f"[cli] python -m ted_spad_tpu_torch.score_video --synthetic {' '.join(extra)}: "
            f"{[(s['clips'], s['frames'], s['max_score']) for s in summaries]} (clips, frames, "
            f"max), K2 launches {fused_double_conv.launches - launches}")


def anomaly_step_gate(device, p, batch, control_batch, card: str) -> None:
    """One train step (dropout 0) on the card and on the CPU from the same weights
    (the seeded init moved off itself, chip_probes.perturbed_mgfn: at the init every
    token has the same magnitude and the top-k picks on rounding noise) and the same
    batch.

    In float64 on both sides the top-k picks, the loss, every gradient and the
    BatchNorm statistics after the step must agree within STEP_*_RTOL, and a CPU step
    on another batch must not: the card computes the same step. In float32, the
    precision the stage trains in, the card's step is held against that float64 CPU
    step beside the CPU's own float32 step: its picks must agree and its loss and
    every gradient stay within STEP_F32_RTOL, which the same card step with TF32 on
    (the control) must exceed. Card and CPU float32 steps differ from each other by
    up to 1.4e-4 of a gradient tensor's norm at this width (PERF.md §6): the
    magnitude-contrastive loss compares L1 magnitudes of LayerNorm outputs that
    differ by a few parts in a thousand and amplifies float32 rounding about
    100-fold, most on tensors the following BatchNorms nearly cancel (Focus's
    two-element rel_pos biases)."""
    import contextlib

    import torch

    import ted_spad_tpu_torch.stages.anomaly_detection as stage
    from ted_spad_tpu_torch.chip_probes import mgfn_step, perturbed_mgfn

    p0 = p.replace(dropout_rate=0.0)
    f64 = torch.float64

    def rel(a: dict, b: dict) -> tuple[float, str]:
        return max((float(torch.linalg.norm(a[k] - b[k]) / torch.linalg.norm(b[k])), k) for k in b)

    def run(dev, dtype, b=batch):
        return mgfn_step(perturbed_mgfn(p0, dev, dtype=dtype), p0, b, dev)

    @contextlib.contextmanager
    def tf32_on():
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    def against(ref, got) -> dict:
        return {"differ": int((got[3] != ref[3]).any(dim=1).sum()),
                "loss": abs(got[0] - ref[0]) / abs(ref[0]),
                "grad": rel(got[1], ref[1]), "stats": rel(got[2], ref[2])}

    ref = run("cpu", f64)
    card64 = against(ref, run(device, f64))
    control = rel(run("cpu", f64, control_batch)[1], ref[1])[0]
    card32, cpu32 = against(ref, run(device, None)), against(ref, run("cpu", None))
    saved_off, stage.tf32_off = stage.tf32_off, tf32_on  # the control: TF32 left on
    try:
        tf32 = against(ref, run(device, None))
    finally:
        stage.tf32_off = saved_off

    def show(r: dict) -> str:
        return (f"picks differ in {r['differ']} videos, loss rel {r['loss']:.3e}, worst gradient "
                f"{r['grad'][0]:.3e} at {r['grad'][1]}, worst BN statistic {r['stats'][0]:.3e}")

    log(f"[anomaly] train step, same weights and batch (dropout 0; smallest k-th to (k+1)-th "
        f"magnitude gap {ref[4]:.3e}), against the CPU's float64 step: card float64 "
        f"{show(card64)} (limits: loss {STEP_LOSS_RTOL}, gradients {STEP_GRAD_RTOL}, statistics "
        f"{STEP_STATS_RTOL}; control, CPU float64 on another batch: worst gradient "
        f"{control:.3e}) | {card}")
    log(f"[anomaly] float32 steps against the CPU's float64 step: card {show(card32)}; CPU "
        f"{show(cpu32)}; card with TF32 on (control) {show(tf32)} (limit {STEP_F32_RTOL}) | {card}")
    if not (card64["differ"] == 0 and card64["loss"] <= STEP_LOSS_RTOL
            and card64["grad"][0] <= STEP_GRAD_RTOL and card64["stats"][0] <= STEP_STATS_RTOL):
        raise AssertionError("the card's float64 MGFN train step disagrees with the CPU's")
    if not control > STEP_GRAD_RTOL:
        raise AssertionError("the step gate does not tell another batch apart")
    if not (card32["differ"] == 0 and card32["loss"] <= STEP_F32_RTOL
            and card32["grad"][0] <= STEP_F32_RTOL):
        raise AssertionError("the card's float32 MGFN train step drifts from the float64 one")
    if not tf32["grad"][0] > STEP_F32_RTOL:
        raise AssertionError("the float32 limit does not reject a TF32 step")


def anomaly_stage(device, workdir: str, serving_features: list[str], card: str) -> dict:
    """Phase 8: the MGFN anomaly stage at the UCF preset's full width on the card,
    through train_anomaly_detection, held against the CPU. Returns the kernels'
    launch counts from the stage's run (none expected)."""
    import numpy as np
    import torch

    import ted_spad_tpu_torch.data.features as fm
    from ted_spad_tpu_torch.chip_probes import time_ms
    from ted_spad_tpu_torch.config.params import MGFNParams
    from ted_spad_tpu_torch.data.features import (
        FeatureDataset, TestFeatureDataset, padded_test_batch, paired_train_batches,
    )
    from ted_spad_tpu_torch.models import load_mgfn_model
    from ted_spad_tpu_torch.ops.temporal import test_features as with_magnitude
    from ted_spad_tpu_torch.stages.anomaly_detection import (
        evaluate, make_optimizer, make_score_fn, make_train_step, train_anomaly_detection,
    )
    from ted_spad_tpu_torch.train_mgfn import write_synthetic_features
    from ted_spad_tpu_torch.utils.checkpoint import save_checkpoint
    from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax

    root = os.path.join(workdir, "anomaly")
    os.makedirs(root)
    t0 = time.perf_counter()
    train_list, test_list, gt = write_synthetic_features(
        root, n_train=ANOMALY_TRAIN_VIDEOS, n_test=ANOMALY_TEST_VIDEOS, feature_size=FEATURE_DIM,
        clips=ANOMALY_CLIPS, frames_per_clip=32, seed=0)
    fm.ABNORMAL_SPLIT["UCF"] = ANOMALY_TRAIN_VIDEOS // 2
    data_mb = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e6
    p = MGFNParams.for_dataset("UCF", rgb_list=train_list, test_rgb_list=test_list)
    log(f"[anomaly] UCF preset: feature {p.feature_size}, dims {p.dims}, depths {p.depths}, "
        f"dim_head {p.dim_head}, {p.batch_size} videos per half, seg_length {p.seg_length}, "
        f"dropout {p.dropout_rate}; {ANOMALY_TRAIN_VIDEOS} training + {ANOMALY_TEST_VIDEOS} test "
        f"videos of {ANOMALY_CLIPS[0]}-{ANOMALY_CLIPS[1] - 1} clips, {data_mb:.1f} MB written in "
        f"{time.perf_counter() - t0:.2f}s, {len(gt)} gt frames")

    # The stage's main path: two epochs through the user's entry point.
    save_dir = os.path.join(root, "ckpt")
    stamps = [time.perf_counter()]

    def epoch_log(msg: str) -> None:
        stamps.append(time.perf_counter())
        log(f"[anomaly] {msg}")

    torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    res = train_anomaly_detection(p, save_dir=save_dir, gt=gt, max_epochs=ANOMALY_EPOCHS,
                                  log_fn=epoch_log, device=device)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    model = res["model"]
    h = res["history"]
    n_params = sum(x.numel() for x in model.parameters())
    walls = [round(b - a, 3) for a, b in zip(stamps, stamps[1:])]
    log(f"[anomaly] train_anomaly_detection: {n_params} params, {ANOMALY_EPOCHS} epochs of "
        f"{ANOMALY_TRAIN_VIDEOS // 2 // p.batch_size} steps, epoch wall time (train + evaluation, "
        f"first includes warm-up) {json.dumps(walls)} s, ROC AUC {json.dumps(h['test_AUC'])}, PR AUC "
        f"{json.dumps(h['test_PR'])}, loss {json.dumps(h['loss'])}, peak device memory "
        f"{peak / 2**20:.1f} MiB, kernel launches {json.dumps(launches)} | {card}")
    aucs = h["test_AUC"] + h["test_PR"]
    if not (len(h["epoch"]) == ANOMALY_EPOCHS and all(0.0 <= a <= 1.0 for a in aucs)
            and all(np.isfinite(h["loss"]))):
        raise AssertionError(f"anomaly stage history out of range: {h}")
    for path in (res["best_path"], res["final_path"]):
        if not (path and os.path.exists(path)):
            raise AssertionError(f"missing checkpoint {path}")

    normal = FeatureDataset(train_list, "UCF", is_normal=True)
    abnormal = FeatureDataset(train_list, "UCF", is_normal=False)
    batch, control = list(paired_train_batches(normal, abnormal, p.batch_size))[:2]
    anomaly_step_gate(device, p, batch, control, card)

    # Train-step time at the real configuration (dropout 0.7), from CUDA events.
    timed = load_mgfn_model(p, saved_model_file=res["final_path"], device=device).requires_grad_(True)
    gen = torch.Generator(device=device).manual_seed(p.seed)
    step = make_train_step(timed, make_optimizer(timed, p), p, generator=gen, device=device)
    dev_batch = [torch.as_tensor(x).to(device) for x in batch]
    step_ms = time_ms(lambda: step(*dev_batch), reps=7, inner=1)
    log(f"[anomaly] train step ({2 * p.batch_size} videos x {p.seg_length} segments, forward + "
        f"backward + Adam): {step_ms:.3f} ms, median of 7 after 3 warm-up steps | {card}")
    log("[anomaly] where a train step's time goes:")
    profile_step(lambda: step(*dev_batch), steps=3)

    # Evaluation on the card against the CPU, from the final checkpoint.
    test_ds = TestFeatureDataset(test_list, "UCF")
    card_model = load_mgfn_model(p, saved_model_file=res["final_path"], device=device)
    cpu_model = load_mgfn_model(p, saved_model_file=res["final_path"], device="cpu")
    evaluate(make_score_fn(card_model, device=device), test_ds, gt)  # warm-up
    t0 = time.perf_counter()
    card_auc = evaluate(make_score_fn(card_model, device=device), test_ds, gt)
    eval_s = time.perf_counter() - t0
    cpu_auc = evaluate(make_score_fn(cpu_model, device="cpu"), test_ds, gt)
    d_roc, d_pr = abs(card_auc[0] - cpu_auc[0]), abs(card_auc[1] - cpu_auc[1])
    log(f"[anomaly] evaluate (buckets of 64, eval_batch 8, {len(test_ds)} videos, prefetched "
        f"loads included): {eval_s * 1e3 / len(test_ds):.3f} ms per video = "
        f"{len(test_ds) / eval_s:.2f} videos/s; card ROC/PR AUC {card_auc[0]:.8f} / "
        f"{card_auc[1]:.8f}, CPU {cpu_auc[0]:.8f} / {cpu_auc[1]:.8f}, |d| {d_roc:.3e} / "
        f"{d_pr:.3e} (limit {EVAL_AUC_ATOL}) | {card}")
    if not (d_roc <= EVAL_AUC_ATOL and d_pr <= EVAL_AUC_ATOL):
        raise AssertionError("evaluation on the card disagrees with the CPU")
    log("[anomaly] where an evaluation's time goes:")
    profile_step(lambda: evaluate(make_score_fn(card_model, device=device), test_ds, gt), steps=1)

    # Checkpoint round trip: the reloaded model scores phase 4's features bit-equal.
    path = os.path.join(root, "roundtrip.ckpt")
    t0 = time.perf_counter()
    save_checkpoint(path, {"mgfn_model_state_dict": state_dict_to_flax(model)})
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    reloaded = load_mgfn_model(p, saved_model_file=res["final_path"], device=device)
    torch.cuda.synchronize(device)
    load_ms = (time.perf_counter() - t0) * 1e3
    live_fn, reloaded_fn = make_score_fn(model, device=device), make_score_fn(reloaded, device=device)
    for feat_path in serving_features:
        video, mask, t = padded_test_batch(with_magnitude(np.load(feat_path)))
        a, b = live_fn(video, mask)[0, :t], reloaded_fn(video, mask)[0, :t]
        if not torch.equal(a, b):
            raise AssertionError(f"{feat_path}: reloaded checkpoint scores differ "
                                 f"({float((a - b).abs().max())})")
    log(f"[anomaly] checkpoint {os.path.getsize(res['final_path']) / 1e6:.3f} MB (flax msgpack), "
        f"save {save_ms:.1f} ms, load into a card model {load_ms:.1f} ms; reloaded final "
        f"checkpoint scores the {len(serving_features)} serving videos' features bit-equal to the "
        f"trained model | {card}")
    return launches


def option_step(device, tag: str, p, fa, ft, fa32, ft32, batch, card: str,
                profile: bool = False) -> dict:
    """One batch of configuration ``p`` through make_extract_step on the card (bf16,
    K1), read for its launches (K1 once, K2 never), timed (``profile``: and profiled),
    and gated against the f32 plain path (plain preprocess, TF32 off) with both
    controls."""
    import torch

    from ted_spad_tpu_torch.chip_probes import time_ms
    from ted_spad_tpu_torch.stages.feature_extraction import make_extract_step

    step = make_extract_step(ft, p, fa, device=device)
    zero_launch_counts()
    got = step(batch)
    torch.cuda.synchronize(device)
    launches = launch_counts()
    log(f"{tag} kernel launches for one {batch.shape[0]}-clip batch: {json.dumps(launches)}")
    if launches != expected(K1=1):
        raise AssertionError(f"{tag}: expected one K1 launch and no other: {launches}")
    ms = time_ms(lambda: step(batch), reps=3, inner=1)
    log(f"{tag} extract step device time {ms:.3f} ms per {batch.shape[0]}-clip batch = "
        f"{batch.shape[0] / ms * 1e3:.2f} clips/s, features {tuple(got.shape)} | {card}")
    if profile:
        profile_step(lambda: step(batch), steps=2)
    ref_step = make_extract_step(ft32, p.replace(compute_dtype="float32"), fa32, use_kernel=False,
                                 device=device)
    feature_gate(got.double(), ref_step(batch).double(),
                 step(batch.flip(-1).contiguous()).double(), tag)
    return launches


def xd_path(device, workdir: str, fa, fa32, card: str) -> dict:
    """XD-Violence serving at full width through extract_features: UNet++ fa,
    InceptionI3d ft, 1024-d .npy files, XD-preset MGFN scores; K1 once per batch."""
    import torch

    from ted_spad_tpu_torch.chip_probes import conv_class, record_int8_convs, time_ms
    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_ft_model
    from ted_spad_tpu_torch.stages.feature_extraction import (
        extract_features, make_extract_step, video_clip_starts,
    )

    p = FeatureExtractionParams(batch_size=16, arch_ft="i3d")
    uris = [f"synthetic://n={SERVING_FRAMES},h=240,w=320,seed={200 + i}" for i in range(XD_VIDEOS)]
    clips_per_video = len(video_clip_starts(SERVING_FRAMES, p.num_frames, p.clip_stride, p.clip_step))
    ft = load_ft_model("i3d", seed=0, device=device)
    log(f"[xd] UNet++ fa, InceptionI3d ft {sum(x.numel() for x in ft.parameters())} params, "
        f"{p.compute_dtype}, {len(uris)} videos x {clips_per_video} clips, batch {p.batch_size}")
    torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    res = extract_features(p, uris, os.path.join(workdir, "features_xd"), fa=fa, ft=ft,
                           decode_hw=(240, 320), num_workers=8, device=device, log_fn=log)
    launches = launch_counts()
    batches = -(-res["clips"] // p.batch_size)
    log(f"[xd] extract_features: {res['clips']} clips in {res['elapsed_s']:.3f}s = "
        f"{res['clips_per_sec']:.2f} clips/s end to end (decode included); kernel launches "
        f"{json.dumps(launches)} for {batches} batches")
    if len(res["saved"]) != len(uris) or res["skipped"]:
        raise AssertionError(f"expected {len(uris)} .npy files, got {res}")
    if launches != expected(K1=batches):
        raise AssertionError(f"[xd] expected K1 x{batches} and no other: {launches}")
    score_videos(res["saved"], (clips_per_video, OPTION_FEATURES["i3d"]), p.clip_step, device,
                 "[xd]", dataset="XD")

    batch = first_batch(uris, p, device)
    step = make_extract_step(ft, p, fa, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    step_ms = time_ms(lambda: step(batch), reps=5, inner=2)
    log(f"[xd] extract step device time {step_ms:.3f} ms per {p.batch_size}-clip batch = "
        f"{p.batch_size / step_ms * 1e3:.2f} clips/s, peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB | {card}")
    profile_step(lambda: step(batch), steps=3)
    ft32 = load_ft_model("i3d", seed=0, dtype="float32", device=device)
    ref_step = make_extract_step(ft32, p.replace(compute_dtype="float32"), fa32, use_kernel=False,
                                 device=device)
    feature_gate(step(batch).double(), ref_step(batch).double(),
                 step(batch.flip(-1).contiguous()).double(), "[xd fidelity]")
    return launches


def ten_crop_kernel(device, card: str) -> dict:
    """K1 over crops against its plain version (chip_probes.K1_CROP_CASES), the
    F.interpolate yardstick against the plain version, then K1's ten windows of one
    serving batch timed beside its bound, the plain version and the yardstick."""
    import torch

    from ted_spad_tpu_torch.chip_probes import (
        HBM_BYTES_PER_S, F32_FLOPS, K1_INTERPOLATE_TOL, k1_clips, k1_crop_check, k1_crops_bound,
        time_ms,
    )
    from ted_spad_tpu_torch.ops import preprocess as pp
    from ted_spad_tpu_torch.ops.augment import multi_crop_resize
    from ted_spad_tpu_torch.utils.device import tf32_off

    worst = k1_crop_check(device, log)
    shape = (16, 16, 240, 320, 3)
    clips = k1_clips(device, shape, seed=97)
    crops = pp.multi_crops(240, 320, 0.8, 10)
    with tf32_off():
        ref = pp.fused_preprocess_reference(clips, crops=crops, out_dtype=torch.float32)
    interp_err = float((multi_crop_resize(clips, 0.8, 224, 224, 10) - ref).abs().max())
    log(f"[ten-crop] multi_crop_resize (F.interpolate, antialias) vs plain at {shape}: max abs "
        f"error {interp_err:.3e} (tolerance {K1_INTERPOLATE_TOL:.0e})")
    if not interp_err <= K1_INTERPOLATE_TOL:
        raise AssertionError(f"the interpolate yardstick does not compute K1's function: {interp_err}")
    del ref
    ms = time_ms(lambda: pp.fused_preprocess(clips, crops=crops))
    device_ms = time_ms(lambda: pp.fused_preprocess(clips, crops=crops), queued=True)
    with tf32_off():
        plain_ms = time_ms(lambda: pp.fused_preprocess_reference(clips, crops=crops), reps=5, inner=1)
    library_ms = time_ms(lambda: multi_crop_resize(clips, 0.8, 224, 224, 10).to(torch.bfloat16),
                         reps=5, inner=1)
    bytes_moved, flops = k1_crops_bound(shape, crops, 224, 224, out_bytes=2)
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound_ms = max(by_bytes, by_ops)
    log(f"[ten-crop] K1, the ten windows of {shape} in one launch, bf16: kernel {ms:.4f} ms (device "
        f"only {device_ms:.4f}) = {bytes_moved / ms * 1e-6:.1f} GB/s, {ms / bound_ms:.2f}x the bound "
        f"{bound_ms:.4f} ms ({bytes_moved} B: the windows' union read, ten 224x224 written; "
        f"{flops} f32 FLOP = {by_ops:.4f} ms); plain {plain_ms:.4f} ms, F.interpolate + bf16 cast "
        f"{library_ms:.4f} ms | {card}")
    return {"ms": ms, "device_only_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations", "library_ms": library_ms,
            "max_abs_err": worst}


def ten_crop_path(device, workdir: str, fa, card: str) -> dict:
    """ncrops=10 on UNet++ + I3Res50 through extract_features: (clips, 10, 2048) files,
    scored by MGFN; K1 once per batch; peak memory."""
    import torch

    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_ft_model
    from ted_spad_tpu_torch.stages.feature_extraction import extract_features, video_clip_starts

    p = FeatureExtractionParams(batch_size=TEN_CROP_BATCH, ncrops=10)
    uris = [f"synthetic://n={SERVING_FRAMES},h=240,w=320,seed=300"]
    clips_per_video = len(video_clip_starts(SERVING_FRAMES, p.num_frames, p.clip_stride, p.clip_step))
    ft = load_ft_model(seed=0, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    res = extract_features(p, uris, os.path.join(workdir, "features_ten_crop"), fa=fa, ft=ft,
                           decode_hw=(240, 320), num_workers=8, device=device, log_fn=log)
    launches = launch_counts()
    batches = -(-res["clips"] // p.batch_size)
    log(f"[ten-crop] extract_features, {p.batch_size} clips x 10 crops per batch: {res['clips']} "
        f"clips in {res['elapsed_s']:.3f}s = {res['clips_per_sec']:.2f} clips/s end to end, peak "
        f"device memory {torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB; kernel launches "
        f"{json.dumps(launches)} for {batches} batches | {card}")
    if len(res["saved"]) != len(uris) or launches != expected(K1=batches):
        raise AssertionError(f"[ten-crop] expected {len(uris)} files and K1 x{batches}: {res}, {launches}")
    score_videos(res["saved"], (clips_per_video, 10, FEATURE_DIM), p.clip_step, device, "[ten-crop]")
    return launches


def quirk_path(device, fa32, card: str) -> dict:
    """quirk_compat: one batch in float32 on the card (K1, TF32 off) against the same
    step on the CPU; the card's step without the scramble must read beyond the limit."""
    import torch

    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
    from ted_spad_tpu_torch.stages.feature_extraction import make_extract_step

    p = FeatureExtractionParams(batch_size=QUIRK_CLIPS, quirk_compat=True, compute_dtype="float32")
    batch = first_batch([f"synthetic://n={SERVING_FRAMES},h=240,w=320,seed=400"], p, device)
    ft32 = load_ft_model(seed=0, dtype="float32", device=device)
    step = make_extract_step(ft32, p, fa32, device=device)
    zero_launch_counts()
    got = step(batch).double()
    torch.cuda.synchronize(device)
    launches = launch_counts()
    if launches != expected(K1=1):
        raise AssertionError(f"[quirk] expected one K1 launch and no other: {launches}")
    control = make_extract_step(ft32, p.replace(quirk_compat=False), fa32, device=device)(batch).double()
    t0 = time.perf_counter()
    cpu_step = make_extract_step(load_ft_model(seed=0, dtype="float32", device="cpu"), p,
                                 load_fa_model(seed=0, dtype="float32", device="cpu"), device="cpu")
    ref = cpu_step(batch.cpu()).double().to(device)
    cpu_s = time.perf_counter() - t0
    err = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    control_err = float(torch.linalg.norm(control - ref) / torch.linalg.norm(ref))
    log(f"[quirk] quirk_compat, {QUIRK_CLIPS} clips in float32: card (K1 {json.dumps(launches)}) vs "
        f"the CPU's step ({cpu_s:.1f}s): ||d|| / ||cpu|| {err:.3e} (limit {QUIRK_RTOL}); control, the "
        f"card's step without the scramble: {control_err:.3e} | {card}")
    if not err <= QUIRK_RTOL < control_err:
        raise AssertionError(f"[quirk] card {err} / control {control_err} against limit {QUIRK_RTOL}")
    return launches


def extraction_options(device, workdir: str, card: str) -> tuple[dict, dict]:
    """Phase 9. Returns the kernels' launch counts by path and K1's ten-crop timing."""
    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model

    fa = load_fa_model(seed=0, device=device)
    fa32 = load_fa_model(seed=0, dtype="float32", device=device)
    launches = {"xd": xd_path(device, workdir, fa, fa32, card)}
    ten_crop = ten_crop_kernel(device, card)
    launches["ten_crop"] = ten_crop_path(device, workdir, fa, card)
    serving_uris = [f"synthetic://n={SERVING_FRAMES},h=240,w=320,seed={i}" for i in range(2)]
    p = FeatureExtractionParams(batch_size=16)
    batch = first_batch(serving_uris, p, device)
    ft, ft32 = (load_ft_model(seed=0, dtype=d, device=device) for d in ("bfloat16", "float32"))
    launches["no_ar"] = option_step(device, "[no_ar]", p.replace(no_ar_distortion=True), fa, ft,
                                    fa32, ft32, batch, card)
    del ft, ft32
    launches["quirk"] = quirk_path(device, fa32, card)
    for arch in ("r3d_18", "mvitv2"):
        ft, ft32 = (load_ft_model(arch, seed=0, dtype=d, device=device) for d in ("bfloat16", "float32"))
        log(f"[{arch}] {sum(x.numel() for x in ft.parameters())} params, UNet++ fa, one "
            f"{p.batch_size}-clip batch, {OPTION_FEATURES[arch]}-d features")
        launches[arch] = option_step(device, f"[{arch}]", p.replace(arch_ft=arch), fa, ft, fa32, ft32,
                                     batch, card, profile=True)
    return launches, ten_crop


def yuv_path(device, workdir: str, fa, fa32, card: str) -> tuple[dict, dict]:
    """Phase 10: YUV420 serving at full width. K3 against its plain version and timed;
    synthetic videos -> extract_features(decode_mode="yuv") -> .npy -> MGFN scores, K3
    once per batch and K1 never; the bf16 features gated against the f32 plain YUV
    path, R/B swapped (K3's output channels reversed) and the previous clip as the
    controls. Returns (K3's kernel-table entry, the path's launches)."""
    import contextlib

    import torch

    import ted_spad_tpu_torch.stages.feature_extraction as fe
    from ted_spad_tpu_torch.chip_probes import k3_check, k3_timing, time_ms
    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_ft_model

    worst = k3_check(device, log)
    entry = k3_timing(device, log)
    entry["max_abs_err"] = worst

    p = FeatureExtractionParams(batch_size=16)
    # The RGB serving path's first videos: the two paths read the same content, where the
    # R/B swap is a strong control (on seeds 500-503 it read only 0.59-0.71 of the spread).
    uris = [f"synthetic://n={SERVING_FRAMES},h=240,w=320,seed={i}" for i in range(YUV_VIDEOS)]
    clips_per_video = len(fe.video_clip_starts(SERVING_FRAMES, p.num_frames, p.clip_stride,
                                               p.clip_step))
    ft = load_ft_model(seed=0, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    res = fe.extract_features(p, uris, os.path.join(workdir, "features_yuv"), fa=fa, ft=ft,
                              decode_hw=(240, 320), num_workers=8, decode_mode="yuv",
                              device=device, log_fn=log)
    launches = launch_counts()
    batches = -(-res["clips"] // p.batch_size)
    log(f"[yuv] extract_features(decode_mode='yuv'): {res['clips']} clips in "
        f"{res['elapsed_s']:.3f}s = {res['clips_per_sec']:.2f} clips/s end to end (decode "
        f"included), peak device memory {torch.cuda.max_memory_allocated(device) / 2**20:.1f} "
        f"MiB; kernel launches {json.dumps(launches)} for {batches} batches | {card}")
    if len(res["saved"]) != len(uris) or res["skipped"] or launches != expected(K3=batches):
        raise AssertionError(f"[yuv] expected {len(uris)} files, K3 x{batches} and no other: "
                             f"{res}, {launches}")
    score_videos(res["saved"], (clips_per_video, FEATURE_DIM), p.clip_step, device, "[yuv]")

    batch = first_batch(uris, p, device, "yuv")
    step = fe.make_extract_step(ft, p, fa, device=device, yuv=True, yuv_hw=(240, 320))
    step_ms = time_ms(lambda: step(batch), reps=5, inner=2)
    log(f"[yuv] extract step device time {step_ms:.3f} ms per {p.batch_size}-clip batch = "
        f"{p.batch_size / step_ms * 1e3:.2f} clips/s (packed rows {tuple(batch.shape)}) | {card}")
    profile_step(lambda: step(batch), steps=3)
    ft32 = load_ft_model(seed=0, dtype="float32", device=device)
    ref_step = fe.make_extract_step(ft32, p.replace(compute_dtype="float32"), fa32,
                                    use_kernel=False, device=device, yuv=True, yuv_hw=(240, 320))

    @contextlib.contextmanager
    def red_blue_swapped():  # the control: K3's output with its channels reversed
        saved = fe.fused_preprocess_yuv
        fe.fused_preprocess_yuv = lambda *a, **k: saved(*a, **k).flip(-1)
        try:
            yield
        finally:
            fe.fused_preprocess_yuv = saved

    got = step(batch).double()
    with red_blue_swapped():
        swapped = step(batch).double()
    feature_gate(got, ref_step(batch).double(), swapped, "[yuv fidelity]")
    return entry, launches


def check_int8_convs(device, calls, card: str) -> dict:
    """K4 against int8_conv_reference bit for bit at every recorded shape (frame / clip
    batch cut to 2 / 1) with its own epilogue form, and at chip_probes.K4_CASES with each
    of the forms; then each conv of one batch timed at its full shape with its form
    (random codes and operands) beside its bound, the plain version and the yardsticks.
    Returns K4's kernel-table entry, launches aside."""
    from ted_spad_tpu_torch.chip_probes import (
        K4_CASES, conv_class, k4_check, k4_classes, k4_timing,
    )

    reduced = [(f"{c[0]} ({conv_class(c)})", (2 if len(c[1]) == 4 else 1,) + c[1][1:], *c[2:])
               for c in calls]
    n = k4_check(device, reduced, log=lambda m: None)
    log(f"[K4] the {len(reduced)} convs of the int8 path, batch cut to 2 frames / 1 clip, each "
        f"with its epilogue form: K4 bit-equal to its plain version in bf16 and f32 ({n} elements)")
    n_ragged = k4_check(device, K4_CASES, log)
    rows = k4_timing(device, calls, log, yardsticks=True)
    totals = {k: sum(r[k] for r in rows)
              for k in ("ms", "device_only_ms", "plain_ms", "bound_ms", "library_ms")}
    mm = {"ms": sum(r["ms"] for r in rows if "int_mm_ms" in r),
          "int_mm_ms": sum(r["int_mm_ms"] for r in rows if "int_mm_ms" in r)}
    by_class = k4_classes(rows)
    for name, agg in by_class.items():
        log(f"[K4] class {name}: {agg['n']} convs, kernel {agg['ms']:.3f} ms (device only "
            f"{agg['device_only_ms']:.3f}), bound "
            f"{agg['bound_ms']:.3f} ms ({agg['ms'] / agg['bound_ms']:.1f}x), cuDNN bf16 "
            f"{agg['library_ms']:.3f} ms ({agg['ms'] / agg['library_ms']:.2f}x cuDNN) | {card}")
    log(f"[K4] the {len(calls)} int8 convs of one 16-clip batch with their fused epilogues: "
        f"kernel {totals['ms']:.3f} ms (device only {totals['device_only_ms']:.3f}), "
        f"plain (float64 convs of the codes + the epilogue's torch ops) {totals['plain_ms']:.3f} "
        f"ms, cuDNN bf16 convs {totals['library_ms']:.3f} ms, bound {totals['bound_ms']:.3f} ms; "
        f"at the 1x1 / 1x1x1 unstrided shapes kernel {mm['ms']:.3f} ms vs torch._int_mm + the "
        f"epilogue's torch ops {mm['int_mm_ms']:.3f} ms | {card}")
    return {"name": "K4 int8_conv", "route": "cuda", "source": "ted_spad_tpu_torch/csrc/int8conv.cu",
            "replaces": "ted_spad_tpu/ops/quant_unetpp.py:125 (_Quantizer.conv and the "
                        "elementwise ops XLA fuses after it; XLA int8 conv, no Pallas kernel)",
            "max_abs_err": 0.0, **totals, "bound_by": "operations" if sum(
                r["bound_by"] == "operations" for r in rows) * 2 >= len(rows) else "bytes",
            "library_int_mm_ms": mm["int_mm_ms"], "int_mm_shapes_ms": mm["ms"],
            "checked_elements": n + n_ragged, "classes": by_class,
            "forms": {f: sum(r["form"] == f for r in rows) for f in sorted({r["form"] for r in rows})}}


def frame_scores(saved: dict, device) -> dict:
    """Each video's UCF MGFN frame scores from its .npy (seeded MGFN)."""
    import numpy as np

    from ted_spad_tpu_torch.config.params import MGFNParams
    from ted_spad_tpu_torch.data.features import padded_test_batch
    from ted_spad_tpu_torch.models import load_mgfn_model
    from ted_spad_tpu_torch.ops.metrics import frame_level_scores
    from ted_spad_tpu_torch.ops.temporal import test_features as with_magnitude
    from ted_spad_tpu_torch.stages.anomaly_detection import make_score_fn

    score_fn = make_score_fn(load_mgfn_model(MGFNParams.for_dataset("UCF"), device=device),
                             device=device)
    out = {}
    for uri, path in saved.items():
        video, mask, t = padded_test_batch(with_magnitude(np.load(path)))
        out[uri] = frame_level_scores(score_fn(video, mask)[0, :t].cpu().numpy(), SERVING_FRAMES,
                                      frames_per_clip=32)
    return out


def int8_path(device, workdir: str, fa, card: str) -> tuple[dict, dict]:
    """Phase 11: the int8 W8A8 serving mode at full width (quant="int8",
    quant_calib_batches=2, I3Res50 quantized too) through extract_features, read for its
    launches (K4 79 times per int8 step, K3 never), then K4 against its plain version at
    every conv shape of the path and timed, and the gates: the int8 step with K4 equals
    the same step with the plain int8 conv bit for bit; the features' cosine to bf16;
    the int8-vs-bf16 error over the between-clip spread beside its controls; MGFN frame
    scores from int8 features against bf16 ones. Returns (K4's entry, the launches)."""
    import numpy as np
    import torch

    import ted_spad_tpu_torch.stages.feature_extraction as fe
    from ted_spad_tpu_torch.chip_probes import conv_class, record_int8_convs, time_ms
    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_ft_model
    from ted_spad_tpu_torch.ops.quant_unetpp import act_scales_from_absmax

    p = FeatureExtractionParams(batch_size=16, quant="int8", quant_calib_batches=2)
    uris = [f"synthetic://n={SERVING_FRAMES},h=240,w=320,seed={600 + i}" for i in range(INT8_VIDEOS)]
    clips_per_video = len(fe.video_clip_starts(SERVING_FRAMES, p.num_frames, p.clip_stride,
                                               p.clip_step))
    ft = load_ft_model(seed=0, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    res = fe.extract_features(p, uris, os.path.join(workdir, "features_int8"), fa=fa, ft=ft,
                              decode_hw=(240, 320), num_workers=8, device=device, log_fn=log)
    launches = launch_counts()
    batches = -(-res["clips"] // p.batch_size)
    # The int8 step runs once per batch and once more on the first batch for the fidelity
    # check; calibration runs the schedule in bf16 and launches no int8 conv.
    steps = batches + 1
    log(f"[int8] extract_features(quant='int8'): {res['clips']} clips in {res['elapsed_s']:.3f}s = "
        f"{res['clips_per_sec']:.2f} clips/s end to end (decode, {res['quant_calib_batches_used']} "
        f"calibration batches and the fidelity check included), peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB; cosine to bf16 "
        f"{res['quant_feature_cossim_vs_bf16']} (limit {INT8_COS_MIN}); kernel launches "
        f"{json.dumps(launches)} for {batches} batches + 1 fidelity step | {card}")
    if len(res["saved"]) != len(uris) or res["skipped"]:
        raise AssertionError(f"[int8] expected {len(uris)} .npy files: {res}")
    if not (launches["K4 int8_conv"] == INT8_CONVS * steps and launches["K3 preprocess_yuv"] == 0
            and launches["K2 double_conv"] == 0 and launches["K1 preprocess"] > 0):
        raise AssertionError(f"[int8] expected K4 x{INT8_CONVS * steps}, K3 and K2 never: {launches}")
    if not res["quant_feature_cossim_vs_bf16"] >= INT8_COS_MIN:
        raise AssertionError(f"[int8] cosine to bf16 {res['quant_feature_cossim_vs_bf16']}")
    score_videos(res["saved"], (clips_per_video, FEATURE_DIM), p.clip_step, device, "[int8]")
    bf16 = fe.extract_features(p.replace(quant="none"), uris,
                               os.path.join(workdir, "features_int8_ref"), fa=fa, ft=ft,
                               decode_hw=(240, 320), num_workers=8, device=device,
                               log_fn=lambda m: None)
    s_int8, s_bf16 = frame_scores(res["saved"], device), frame_scores(bf16["saved"], device)
    d_scores = max(float(np.abs(s_int8[u] - s_bf16[u]).max()) for u in uris)
    log(f"[int8] MGFN frame scores from int8 vs bf16 features, {len(uris)} videos: max |d| "
        f"{d_scores:.6f} (limit {INT8_SCORE_ATOL})")
    if not d_scores <= INT8_SCORE_ATOL:
        raise AssertionError(f"[int8] MGFN scores move {d_scores} with int8 features")

    # The step, with the run's scales recomputed as the stage computes them.
    b = [torch.from_numpy(c).to(device) for c, _, _ in
         fe.iter_clip_batches(uris, p, p.batch_size, num_workers=8)][:2]
    calib = fe.make_fa_calibration_step(p, fa, ft, device=device)
    absmax: dict = {}
    for clips in b:
        for k, v in calib(clips).items():
            absmax[k] = max(absmax.get(k, 0.0), float(v))
    scales = act_scales_from_absmax(absmax)
    batch = b[0]
    step = fe.make_extract_step(ft, p, fa, device=device, quant_act_scales=scales)
    twin = fe.make_extract_step(ft, p, fa, device=device, quant_act_scales=scales, int8_kernel=False)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        got, plain = step(batch), twin(batch)
    torch.cuda.synchronize(device)
    same = torch.equal(got, plain)
    log(f"[int8] the int8 step with K4 vs the same step with the plain int8 conv (same scales, "
        f"cuDNN deterministic): {'bit-equal' if same else 'DIFFERENT'}, max |d| "
        f"{float((got - plain).abs().max()):.3e}")
    if not same:
        raise AssertionError("[int8] the step through K4 differs from its plain-conv twin")
    calls = record_int8_convs(step, batch)
    log(f"[int8] one int8 step runs {len(calls)} int8 convs: "
        f"{json.dumps({c: sum(conv_class(x) == c for x in calls) for c in sorted({conv_class(x) for x in calls})})}; "
        f"epilogue forms {json.dumps({f: sum(x[-1] == f for x in calls) for f in sorted({x[-1] for x in calls})})}")
    if len(calls) != INT8_CONVS:
        raise AssertionError(f"[int8] expected {INT8_CONVS} int8 convs per step, got {len(calls)}")
    step_ms = time_ms(lambda: step(batch), reps=5, inner=2)
    bf16_step = fe.make_extract_step(ft, p.replace(quant="none"), fa, device=device)
    bf16_ms = time_ms(lambda: bf16_step(batch), reps=5, inner=2)
    log(f"[int8] extract step device time {step_ms:.3f} ms per {p.batch_size}-clip batch = "
        f"{p.batch_size / step_ms * 1e3:.2f} clips/s (the bf16 step in this run: {bf16_ms:.3f} ms) "
        f"| {card}")
    profile_step(lambda: step(batch), steps=3)

    # Fidelity: int8 against bf16 features, over the spread between clips, with controls.
    ref = bf16_step(batch).double()
    readings = {"int8": got.double(), "control R/B swapped": step(batch.flip(-1).contiguous()).double(),
                "control previous clip": got.double().roll(1, dims=0)}
    errs = {}
    for name, x in readings.items():
        cos_min, errs[name] = fidelity(x, ref)
        log(f"[int8 fidelity] {name} vs the bf16 path, {got.shape[0]} clips: min cosine "
            f"{cos_min:.8f}, error / between-clip spread {errs[name]:.6f}")
    reading = errs.pop("int8")
    for name, err in errs.items():
        if not err > reading:
            raise AssertionError(f"[int8] the {name} reads {err}, not above the int8 reading {reading}")

    entry = check_int8_convs(device, calls, card)
    return entry, launches


def _train_readings(model) -> tuple[dict, dict]:
    """(gradients, BN running statistics) of a model after a step, float64 on the CPU."""
    grads = {n: q.grad.double().cpu() for n, q in model.named_parameters()}
    stats = {n: t.double().cpu() for n, t in model.named_buffers() if "running" in n}
    return grads, stats


def _fa_gate_step(device, dtype, images, draw) -> tuple:
    """One fa pretraining step (TF32 off) of the seeded full-width UNet++ in ``dtype``:
    (loss, gradients, statistics, the signs of the L1 residual recon - input)."""
    import torch

    from ted_spad_tpu_torch.models import load_fa_model
    from ted_spad_tpu_torch.stages.common import make_optimizer
    from ted_spad_tpu_torch.stages.fa_pretraining import make_train_step
    from ted_spad_tpu_torch.utils.device import tf32_off

    side = TRAIN_GATE_FA[1]
    model = load_fa_model(seed=0, dtype="float32", device=device).to(dtype).requires_grad_(True)
    seen = {}

    def keep_sign(mod, inp, out) -> None:
        seen["sign"] = torch.sign(out.detach() - inp[0]).cpu()

    hook = model.register_forward_hook(keep_sign)
    step = make_train_step(model, make_optimizer(model.parameters(), "adam", 1e-3), (side, side),
                           compute_dtype="float32", device=device)
    with tf32_off():
        loss = float(step(images, draw))
    hook.remove()
    return (loss, *_train_readings(model), seen["sign"])


def _ft_gate_step(device, dtype, p, batch) -> tuple:
    """One action training step (TF32 off, dropout 0) of the seeded full-width ft of
    ``p.arch`` (I3Res50 with its head by default) in ``dtype``: (loss, gradients,
    statistics)."""
    from ted_spad_tpu_torch.models import load_ft_model
    from ted_spad_tpu_torch.stages.action_training import make_train_step
    from ted_spad_tpu_torch.stages.common import make_optimizer
    from ted_spad_tpu_torch.utils.device import tf32_off

    model = load_ft_model(p.arch, seed=0, dtype="float32", device=device, num_classes=p.num_classes,
                          dropout_rate=0.0, clip_shape=(p.num_frames, p.reso_h, p.reso_w))
    model = model.to(dtype).requires_grad_(True)
    opt = make_optimizer(model.parameters(), p.opt_type, p.learning_rate, p.weight_decay, p.momentum)
    step = make_train_step(model, opt, p, device=device)
    with tf32_off():
        loss = float(step(batch.clips, batch.labels, batch.params))
    return (loss, *_train_readings(model))


def _step_against(ref: tuple, got: tuple) -> dict:
    """A step's readings against a reference step's: the loss's relative error, the
    worst gradient (||d|| / ||g||, the tensors whose gradient is zero in exact
    arithmetic held apart, as a share of the largest gradient) and the worst BN
    statistic (statistics that did not move, FrozenBN's, must be equal)."""
    import torch

    def rel(a, b) -> float:
        d, n = float(torch.linalg.norm(a - b)), float(torch.linalg.norm(b))
        return d / n if n else (0.0 if d == 0 else float("inf"))

    top = max(float(torch.linalg.norm(g)) for g in ref[1].values())
    null = {k for k, g in ref[1].items() if float(torch.linalg.norm(g)) <= TRAIN_NULL_GRAD * top}
    grad = max((rel(got[1][k], ref[1][k]), k) for k in ref[1] if k not in null)
    null_worst = max([float(torch.linalg.norm(got[1][k])) / top for k in null] + [0.0])
    stats = max([(rel(got[2][k], ref[2][k]), k) for k in ref[2]] or [(0.0, "none (no BN)")])
    return {"loss": abs(got[0] - ref[0]) / abs(ref[0]), "grad": grad, "stats": stats,
            "null": (len(null), null_worst)}


def show_step(r: dict) -> str:
    """One line of a step against a reference step (``_step_against``)."""
    return (f"loss rel {r['loss']:.3e}, worst gradient {r['grad'][0]:.3e} at {r['grad'][1]}, "
            f"worst BN statistic {r['stats'][0]:.3e} at {r['stats'][1]}, {r['null'][0]} "
            f"zero-in-exact-arithmetic gradients at most {r['null'][1]:.1e} of the largest")


def training_gate(device, card: str) -> None:
    """Card against CPU: one step of each stage at full width from the same seeded
    weights, batch and augmentation draw, TF32 off, dropout 0 (fa: 2 images of 224^2;
    ft: 2 videos x 3 'trip' views of 16 x 112^2), through make_train_step, held against
    the CPU's float64 step (TRAIN_* limits; the card's float32 gradients printed, the fa's
    with its L1 sign flips), the card's float32 step on another batch the control."""
    import numpy as np
    import torch

    from ted_spad_tpu_torch.config.params import ActionParams
    from ted_spad_tpu_torch.data.images import ReconstructionSource, sample_image_augment_params
    from ted_spad_tpu_torch.data.videos import ClipDataset, synthetic_video_items

    n, side = TRAIN_GATE_FA
    src = ReconstructionSource(synthetic_n=2 * n, seed=0)
    rng = np.random.default_rng(0)
    fa_batches = [(src.get_batch(list(range(i * n, (i + 1) * n)))[0],
                   sample_image_augment_params(rng, n, src.canonical, side, side)) for i in (0, 1)]
    n, side = TRAIN_GATE_FT
    p = ActionParams(num_frames=16, reso_h=side, reso_w=side, temporal_loss="trip", batch_size=n,
                     compute_dtype="float32")
    items = synthetic_video_items(2 * n, p.num_classes, num_frames=64, h=240, w=320, seed=0)
    ft_batches = [(b,) for b in list(ClipDataset(items, p, views=3, num_workers=4, seed=0)
                                     .batches(n, seed=1))[:2]]

    f64 = torch.float64
    for name, run, batches in (("fa", _fa_gate_step, fa_batches),
                               ("ft", lambda d, t, b: _ft_gate_step(d, t, p, b), ft_batches)):
        t0 = time.perf_counter()
        ref = run("cpu", f64, *batches[0])
        card64 = _step_against(ref, run(device, f64, *batches[0]))
        got32 = run(device, torch.float32, *batches[0])
        card32 = _step_against(ref, got32)
        control = _step_against(ref, run(device, torch.float32, *batches[1]))
        flips = f", L1 residual signs flipped {int((got32[3] != ref[3]).sum())} of {ref[3].numel()}" \
            if name == "fa" else ""
        log(f"[train] {name} step against the CPU's float64 step (same weights, batch and draw; TF32 "
            f"off): card float64 {show_step(card64)}; card float32 {show_step(card32)}{flips} (limits: loss "
            f"{TRAIN_LOSS_RTOL}, gradients {TRAIN_GRAD_RTOL}, statistics {TRAIN_STATS_RTOL}, zero "
            f"gradients {TRAIN_NULL_GRAD}); control, the card's float32 step on another batch: "
            f"{show_step(control)}; {time.perf_counter() - t0:.1f}s | {card}")
        for label, r, grads in (("float64", card64, True), ("float32", card32, False)):
            if not (r["loss"] <= TRAIN_LOSS_RTOL and r["stats"][0] <= TRAIN_STATS_RTOL
                    and r["null"][1] <= TRAIN_NULL_GRAD
                    and (not grads or r["grad"][0] <= TRAIN_GRAD_RTOL)):
                raise AssertionError(f"the card's {label} {name} train step disagrees with the CPU's")
        if not (control["loss"] > TRAIN_LOSS_RTOL and control["grad"][0] > TRAIN_GRAD_RTOL
                and control["stats"][0] > TRAIN_STATS_RTOL):
            raise AssertionError(f"the {name} step gate does not tell another batch apart")


def _timed_steps(step, n: int) -> list[float]:
    """ms of each of ``n`` steps after one warm-up step, from CUDA events."""
    import torch

    step()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def training_steps(device, card: str) -> int:
    """The full-width bf16 steps timed: the fa step (UNet++ at 224^2, batch 32) and the
    ft step (I3Res50 with its head, 16 x 224^2, 'trip', FrozenBN, dropout 0.5, 16
    videos x 3 views, or 8 where they do not fit). Returns the ft batch used."""
    import numpy as np
    import torch

    from ted_spad_tpu_torch.config.params import ActionParams, ReconstructionParams
    from ted_spad_tpu_torch.data.images import ReconstructionSource, sample_image_augment_params
    from ted_spad_tpu_torch.data.videos import ClipDataset, synthetic_video_items
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
    from ted_spad_tpu_torch.ops.augment import AugmentParams
    from ted_spad_tpu_torch.stages import action_training, fa_pretraining
    from ted_spad_tpu_torch.stages.common import make_optimizer

    rp = ReconstructionParams()
    torch.cuda.reset_peak_memory_stats(device)
    fa = load_fa_model(rp.arch_fa, seed=0, dtype="float32", device=device).requires_grad_(True)
    step = fa_pretraining.make_train_step(
        fa, make_optimizer(fa.parameters(), "adam", rp.learning_rate), (rp.reso_h, rp.reso_w),
        compute_dtype=rp.compute_dtype, device=device)
    src = ReconstructionSource(synthetic_n=TRAIN_FA_BATCH, seed=0)
    images = torch.from_numpy(src.get_batch(list(range(TRAIN_FA_BATCH)))[0]).to(device)
    draw = sample_image_augment_params(np.random.default_rng(0), TRAIN_FA_BATCH, src.canonical,
                                       rp.reso_h, rp.reso_w)
    ms = _timed_steps(lambda: step(images, draw), TRAIN_TIMED_STEPS)
    n_params = sum(q.numel() for q in fa.parameters())
    mean = sum(ms) / len(ms)
    log(f"[train] fa step (UNet++ {n_params:,} params, {TRAIN_FA_BATCH} images of {rp.reso_h}^2, "
        f"{rp.compute_dtype} autocast, augment + forward + L1 + backward + Adam): steps "
        f"{json.dumps([round(x, 3) for x in ms])} ms, mean {mean:.3f} ms/step = "
        f"{TRAIN_FA_BATCH * 1e3 / mean:.1f} images/s, peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB | {card}")
    log("[train] where an fa step's time goes:")
    profile_step(lambda: step(images, draw), steps=2)
    del fa, step, images
    torch.cuda.empty_cache()

    p = ActionParams(temporal_loss="trip")
    items = synthetic_video_items(TRAIN_FT_BATCHES[0], p.num_classes, num_frames=64, h=240, w=320,
                                  seed=0)
    batch = next(ClipDataset(items, p, views=3, num_workers=8, seed=0).batches(TRAIN_FT_BATCHES[0]))
    for b in TRAIN_FT_BATCHES:
        torch.cuda.reset_peak_memory_stats(device)
        ft = load_ft_model(p.arch, seed=0, dtype="float32", device=device, num_classes=p.num_classes,
                           dropout_rate=p.ft_dropout or None).requires_grad_(True)
        gen = torch.Generator(device=device).manual_seed(0)
        opt = make_optimizer(ft.parameters(), p.opt_type, p.learning_rate, p.weight_decay, p.momentum)
        step = action_training.make_train_step(ft, opt, p, generator=gen, device=device)
        clips = torch.from_numpy(batch.clips[:b]).to(device)
        draw = AugmentParams(**{k: v[:b * 3] for k, v in vars(batch.params).items()})
        try:
            ms = _timed_steps(lambda: step(clips, batch.labels[:b], draw), TRAIN_TIMED_STEPS)
        except torch.cuda.OutOfMemoryError:
            log(f"[train] ft step: {b} videos x 3 views do not fit in the card's memory")
            del ft, step, opt, clips
            torch.cuda.empty_cache()
            continue
        break
    else:
        raise AssertionError("no ft batch fits in the card's memory")
    mean = sum(ms) / len(ms)
    n_params = sum(q.numel() for q in ft.parameters())
    log(f"[train] ft step (I3Res50 + head {n_params:,} params, {b} videos x 3 'trip' views of "
        f"{p.num_frames} x {p.reso_h}^2{'' if b == TRAIN_FT_BATCHES[0] else ', batch cut from 16'}, "
        f"FrozenBN, dropout {ft.i3d.dropout_rate}, {p.compute_dtype} autocast, augment + forward + "
        f"CE + triplet + backward + Adam): steps {json.dumps([round(x, 3) for x in ms])} ms, mean "
        f"{mean:.3f} ms/step = {b * 1e3 / mean:.2f} clips/s ({3 * b * 1e3 / mean:.2f} views/s), peak "
        f"device memory {torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB | {card}")
    log("[train] where an ft step's time goes:")
    profile_step(lambda: step(clips, batch.labels[:b], draw), steps=2)
    del ft, step, opt, clips
    torch.cuda.empty_cache()
    return b


def training_drivers(device, workdir: str, ft_batch: int, card: str) -> dict:
    """The stage drivers end to end at full width: train_reconstruction (UNet++,
    224^2, batch 32) and anonymized train_action ('trip', through the fa the first
    just saved) for one epoch of TRAIN_DRIVER_STEPS steps each on synthetic sources.
    Checkpoints written and reloading bit-equal, finite losses; then the trained fa and
    ft load into the serving loaders and extract one batch. Returns the kernels' launch
    counts from the drivers' run (none expected)."""
    import numpy as np
    import torch

    from ted_spad_tpu_torch.config.params import (
        ActionParams, FeatureExtractionParams, ReconstructionParams,
    )
    from ted_spad_tpu_torch.data.images import ReconstructionSource
    from ted_spad_tpu_torch.data.videos import synthetic_video_items
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
    from ted_spad_tpu_torch.stages.action_training import train_action
    from ted_spad_tpu_torch.stages.fa_pretraining import train_reconstruction
    from ted_spad_tpu_torch.stages.feature_extraction import make_extract_step

    root = os.path.join(workdir, "training")
    rp = ReconstructionParams()
    ap = ActionParams(temporal_loss="trip", batch_size=ft_batch, v_batch_size=8, num_modes=1,
                      anonymized=True)
    stamps = [time.perf_counter()]

    def stage_log(msg: str) -> None:
        stamps.append(time.perf_counter())
        log(f"[train] {msg}")

    zero_launch_counts()
    fa_res = train_reconstruction(
        rp, train_source=ReconstructionSource(synthetic_n=rp.batch_size * TRAIN_DRIVER_STEPS, seed=0),
        val_source=ReconstructionSource(synthetic_n=rp.batch_size, seed=1), save_dir=root,
        max_epochs=1, log_fn=stage_log, device=device)
    ap = ap.replace(saved_model_fa=fa_res["best_path"])
    ft_res = train_action(
        ap, train_items=synthetic_video_items(ft_batch * TRAIN_DRIVER_STEPS, ap.num_classes,
                                              num_frames=64, h=240, w=320, seed=0),
        val_items=synthetic_video_items(8, ap.num_classes, num_frames=64, h=240, w=320, seed=1),
        save_dir=root, max_epochs=1, log_fn=stage_log, device=device)
    launches = launch_counts()
    walls = [round(b - a, 3) for a, b in zip(stamps, stamps[1:])]
    h_fa, h_ft = fa_res["history"], ft_res["history"]
    log(f"[train] train_reconstruction: {TRAIN_DRIVER_STEPS} steps of {rp.batch_size}, train L1 "
        f"{h_fa['train_loss']}, val L1 {h_fa['val_loss']}; train_action (anonymized, 'trip', "
        f"{TRAIN_DRIVER_STEPS} steps of {ft_batch} videos): loss {h_ft['train_loss']}, top-1 "
        f"{h_ft['val_acc']}; wall time per epoch (train + validation + checkpoints, first steps "
        f"warm up) {json.dumps(walls)} s; kernel launches {json.dumps(launches)} | {card}")
    for h, key in ((h_fa, "val_loss"), (h_ft, "val_acc")):
        if not (len(h["train_loss"]) == len(h[key]) == 1 and np.isfinite(h["train_loss"] + h[key]).all()):
            raise AssertionError(f"stage history out of range: {h}")
    temps = [os.path.join(root, r, "model_temp.ckpt") for r in (rp.run_id, ap.run_id)]
    for path in [fa_res["best_path"], ft_res["best_path"], *temps]:
        if not (path and os.path.exists(path)):
            raise AssertionError(f"missing checkpoint {path}")

    # The checkpoints reload bit-equal, then serve: the default extraction step (bf16).
    fa32 = load_fa_model(saved_model_file=fa_res["best_path"], dtype="float32", device=device)
    ft32 = load_ft_model(saved_model_file=ft_res["best_path"], dtype="float32", device=device)
    for trained, reloaded in ((fa_res["model"], fa32), (ft_res["model"], ft32)):
        if not _same_weights(trained, reloaded):
            raise AssertionError("a trained model's checkpoint does not reload bit-equal")
    del fa32, ft32
    p = FeatureExtractionParams(batch_size=4)
    fa = load_fa_model(saved_model_file=fa_res["best_path"], device=device)
    ft = load_ft_model(saved_model_file=ft_res["best_path"], device=device)
    batch = first_batch([f"synthetic://n=64,h=240,w=320,seed={s}" for s in range(2)], p, device)
    feats = make_extract_step(ft, p, fa, device=device)(batch)
    torch.cuda.synchronize(device)
    if not (feats.shape == (batch.shape[0], FEATURE_DIM) and bool(torch.isfinite(feats).all())):
        raise AssertionError(f"trained models' features: {tuple(feats.shape)}, finite "
                             f"{bool(torch.isfinite(feats).all())}")
    log(f"[train] checkpoints ({os.path.getsize(fa_res['best_path']) / 1e6:.2f} MB fa, "
        f"{os.path.getsize(ft_res['best_path']) / 1e6:.2f} MB ft, flax msgpack) reload bit-equal; "
        f"the trained fa and ft ({ft.i3d.fc.out_features}-class head read from the file) extract "
        f"one {batch.shape[0]}-clip batch through the serving step: {tuple(feats.shape)} finite | {card}")
    return launches


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def training_phase(device, workdir: str, card: str) -> dict:
    """Phase 12: training the models the serving path runs. Returns the kernels' launch
    counts from the stage drivers' run."""
    t0 = time.perf_counter()
    training_gate(device, card)
    ft_batch = training_steps(device, card)
    launches = training_drivers(device, workdir, ft_batch, card)
    log(f"[train] phase time {time.perf_counter() - t0:.1f}s")
    return launches


def _priv_batches(n: int, side: int, count: int = 2) -> list:
    """``count`` privacy batches of ``n`` synthetic images (256^2 canonical): (images,
    labels, draw at ``side``)."""
    import numpy as np

    from ted_spad_tpu_torch.data.images import SyntheticImageSource, sample_image_augment_params

    src = SyntheticImageSource(n=n * count, seed=0)
    rng = np.random.default_rng(0)
    return [(*src.get_batch(list(range(i * n, (i + 1) * n))),
             sample_image_augment_params(rng, n, src.canonical, side, side)) for i in range(count)]


def _privacy_gate_step(device, dtype, images, labels, draw) -> tuple:
    """One privacy step (TF32 off) of the seeded full-width ResNet50Classifier in
    ``dtype`` on images anonymized by the seeded UNet++: (loss, gradients, statistics)."""
    import torch

    from ted_spad_tpu_torch.models import load_fa_model, load_fb_model
    from ted_spad_tpu_torch.stages.common import make_optimizer
    from ted_spad_tpu_torch.stages.privacy_training import make_steps
    from ted_spad_tpu_torch.utils.device import tf32_off

    side = PRIV_GATE[1]
    fb = load_fb_model(seed=0, dtype="float32", device=device).to(dtype).requires_grad_(True)
    fa = load_fa_model(seed=0, dtype="float32", device=device).to(dtype)
    train_step, _ = make_steps(fb, fa, make_optimizer(fb.parameters(), "adam", 1e-3), (side, side),
                               compute_dtype="float32", device=device)
    with tf32_off():
        loss = float(train_step(images, labels, draw))
    del fa
    return (loss, *_train_readings(fb))


def _first_videos(batch, n: int):
    """A training ClipBatch cut to its first ``n`` videos (their views' draws with
    them): the dataset drops batches of one video (the reference's collate filter)."""
    import dataclasses

    from ted_spad_tpu_torch.ops.augment import AugmentParams

    v = batch.clips.shape[1]
    draw = AugmentParams(**{k: x[:n * v] for k, x in vars(batch.params).items()})
    return dataclasses.replace(batch, clips=batch.clips[:n], labels=batch.labels[:n], params=draw,
                               indices=None if batch.indices is None else batch.indices[:n])


def _adv_inputs(p, n_videos: int, n_pairs: int, count: int = 2) -> list:
    """``count`` adversarial batches, augmented on the CPU in float64: (vispr1, vispr2,
    clips, labels) of ``n_pairs`` VISPR pairs and ``n_videos`` videos x 3 views."""
    import torch

    from ted_spad_tpu_torch.data.images import SyntheticImageSource, vispr_batches
    from ted_spad_tpu_torch.data.videos import ClipDataset, synthetic_video_items
    from ted_spad_tpu_torch.stages.anonymization_training import augment_inputs

    items = synthetic_video_items(max(n_videos, 2) * count, p.num_classes, num_frames=64, h=240, w=320, seed=0)
    ds = ClipDataset(items, p, views=3, num_workers=8, seed=0)
    try:
        videos = [_first_videos(b, n_videos) for b in list(ds.batches(max(n_videos, 2), seed=1))[:count]]
    finally:
        ds.close()
    pairs = list(vispr_batches(SyntheticImageSource(n=n_pairs * count, seed=0), n_pairs, ssl=True,
                               out_h=p.reso_h, out_w=p.reso_w, seed=1))[:count]
    return [augment_inputs(v, c, p, torch.device("cpu"), torch.float64) for v, c in zip(pairs, videos)]


def _adv_models(device, dtype, p, dropout_rate: float | None = 0.0) -> tuple:
    """The seeded full-width fa (``p.arch_fa``), fb (ResNet50SSL) and ft (``p.arch_ft``,
    I3Res50 with its head by default) in ``dtype``, each requiring grad."""
    from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model

    kw = dict(seed=0, dtype="float32", device=device)
    fa = load_fa_model(p.arch_fa, **kw)
    fb = load_fb_model(ssl=True, **kw)
    ft = load_ft_model(p.arch_ft, num_classes=p.num_classes, dropout_rate=dropout_rate,
                       clip_shape=(p.num_frames, p.reso_h, p.reso_w), **kw)
    return tuple(m.to(dtype).requires_grad_(True) for m in (fa, fb, ft))


def _adv_gate_step(device, dtype, which: str, p, inputs) -> tuple:
    """One fa step or fb/ft step (TF32 off, dropout 0) from the seeded full-width
    models in ``dtype``: (loss, gradients, statistics) of the models it trains. The fa
    step's frozen fb and ft must hold no gradient afterwards."""
    import torch

    from ted_spad_tpu_torch.stages import anonymization_training as anon
    from ted_spad_tpu_torch.stages.common import make_optimizer
    from ted_spad_tpu_torch.utils.device import tf32_off

    fa, fb, ft = _adv_models(device, dtype, p)
    v1, v2, clips, labels = (t.to(device, dtype) if t.is_floating_point() else t.to(device)
                             for t in inputs)
    with tf32_off():
        if which == "fa":
            step = anon.make_fa_step(fa, fb, ft, make_optimizer(fa.parameters(), "adam", 1e-3), p,
                                     device=device)
            loss = float(step(v1, v2, clips, labels)[0])
            if any(q.grad is not None for m in (fb, ft) for q in m.parameters()):
                raise AssertionError("the fa step left a gradient on the frozen fb or ft")
            trained = {"fa": fa}
        else:
            step = anon.make_fbft_step(fa, fb, ft, make_optimizer(fb.parameters(), "adam", 1e-3),
                                       make_optimizer(ft.parameters(), "adam", 1e-3), p,
                                       generator=torch.Generator(device=device).manual_seed(0),
                                       device=device)
            losses = step(v1, v2, clips, labels)
            loss = float(losses[0] + losses[1])
            trained = {"fb": fb, "ft": ft}
    grads, stats = {}, {}
    for name, m in trained.items():
        g, st = _train_readings(m)
        grads.update({f"{name}.{k}": v for k, v in g.items()})
        stats.update({f"{name}.{k}": v for k, v in st.items()})
    return loss, grads, stats


def privacy_gate(device, card: str) -> None:
    """Card against CPU: the privacy step, the fa step and the fb/ft step at full width
    from the same seeded weights, batch and augmentation draw (TF32 off, dropout 0);
    the card under remat "on", the CPU under "off"; held to phase 12's float64 limits
    (TRAIN_*: loss, every gradient, every BN statistic), the card's float32 step to the
    loss limit with its gradients and statistics printed (the fb/ft step's MLP head
    normalizes 6 embeddings in train mode, and float32 rounding moves its statistics by
    2.3e-4 on an H100), the card's float32 step on another batch the control, which must
    exceed each limit."""
    import torch

    from ted_spad_tpu_torch.config.params import AnonymizationParams

    n_videos, n_pairs, side = ADV_GATE
    base = dict(num_frames=16, reso_h=side, reso_w=side, compute_dtype="float32")
    p_on = AnonymizationParams(**base, remat="on")
    p_off = AnonymizationParams(**base, remat="off")
    adv = _adv_inputs(p_on, n_videos, n_pairs)
    cases = (
        ("privacy", lambda d, t, b: _privacy_gate_step(d, t, *b), _priv_batches(*PRIV_GATE),
         "4 images of 224^2 through the UNet++ fa"),
        ("fa", lambda d, t, b: _adv_gate_step(d, t, "fa", p_on if d != "cpu" else p_off, b), adv,
         f"{n_videos} videos x 3 views x 16 x {side}^2 + {n_pairs} VISPR pairs"),
        ("fb/ft", lambda d, t, b: _adv_gate_step(d, t, "fbft", p_on if d != "cpu" else p_off, b), adv,
         f"{n_videos} videos x 3 views x 16 x {side}^2 + {n_pairs} VISPR pairs"),
    )
    f64 = torch.float64
    for name, run, batches, what in cases:
        t0 = time.perf_counter()
        ref = run("cpu", f64, batches[0])
        card64 = _step_against(ref, run(device, f64, batches[0]))
        card32 = _step_against(ref, run(device, torch.float32, batches[0]))
        control = _step_against(ref, run(device, torch.float32, batches[1]))
        log(f"[privacy] {name} step ({what}) against the CPU's float64 step (same weights, batch "
            f"and draw; TF32 off; card remat on, CPU off): card float64 {show_step(card64)}; card float32 "
            f"{show_step(card32)} (limits: loss {TRAIN_LOSS_RTOL}, gradients {TRAIN_GRAD_RTOL}, statistics "
            f"{TRAIN_STATS_RTOL}, zero gradients {TRAIN_NULL_GRAD}); control, the card's float32 step "
            f"on another batch: {show_step(control)}; {time.perf_counter() - t0:.1f}s | {card}")
        if not (card64["loss"] <= TRAIN_LOSS_RTOL and card64["stats"][0] <= TRAIN_STATS_RTOL
                and card64["null"][1] <= TRAIN_NULL_GRAD and card64["grad"][0] <= TRAIN_GRAD_RTOL):
            raise AssertionError(f"the card's float64 {name} step disagrees with the CPU's")
        if not card32["loss"] <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"the card's float32 {name} step's loss disagrees with the CPU's")
        if not (control["loss"] > TRAIN_LOSS_RTOL and control["grad"][0] > TRAIN_GRAD_RTOL
                and control["stats"][0] > TRAIN_STATS_RTOL):
            raise AssertionError(f"the {name} step gate does not tell another batch apart")


def _step_line(tag: str, what: str, ms: list, items: float, unit: str, device, card: str) -> None:
    import torch

    mean = sum(ms) / len(ms)
    log(f"[{tag}] {what}: steps {json.dumps([round(x, 3) for x in ms])} ms, mean {mean:.3f} ms/step "
        f"= {items * 1e3 / mean:.2f} {unit}/s, peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB | {card}")


def privacy_steps(device, card: str) -> None:
    """The full-width bf16 steps timed: the privacy step at PrivacyParams' defaults
    (32 images of 224^2 through the bf16 UNet++ fa), then the fa step and the fb/ft
    step at AnonymizationParams' defaults under each ADV_TIMED configuration, with
    peak memory and a device profile."""
    import torch

    from ted_spad_tpu_torch.config.params import AnonymizationParams, PrivacyParams
    from ted_spad_tpu_torch.models import load_fa_model, load_fb_model
    from ted_spad_tpu_torch.stages import anonymization_training as anon
    from ted_spad_tpu_torch.stages.common import make_optimizer
    from ted_spad_tpu_torch.stages.privacy_training import make_steps

    pp = PrivacyParams()
    fb = load_fb_model(num_pa=pp.num_pa, seed=0, dtype="float32", device=device).requires_grad_(True)
    fa = load_fa_model(seed=0, dtype=pp.compute_dtype, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    train_step, _ = make_steps(fb, fa, make_optimizer(fb.parameters(), "adam", pp.learning_rate),
                               (pp.reso_h, pp.reso_w), compute_dtype=pp.compute_dtype, device=device)
    images, labels, draw = _priv_batches(pp.batch_size, pp.reso_h, count=1)[0]
    images = torch.from_numpy(images).to(device)
    ms = _timed_steps(lambda: train_step(images, labels, draw), ADV_TIMED_STEPS)
    _step_line("privacy", f"privacy step (ResNet50Classifier {sum(q.numel() for q in fb.parameters()):,} "
               f"params, {pp.batch_size} images of {pp.reso_h}^2 through the {pp.compute_dtype} UNet++ fa, "
               f"{pp.compute_dtype} autocast, augment + fa + forward + BCE + backward + Adam)", ms,
               pp.batch_size, "images", device, card)
    log("[privacy] where a privacy step's time goes:")
    profile_step(lambda: train_step(images, labels, draw), steps=1)
    del fb, fa, train_step, images
    torch.cuda.empty_cache()

    p = AnonymizationParams()
    fa, fb, ft = _adv_models(device, torch.float32, p, dropout_rate=None)
    inputs = _adv_inputs(p, p.batch_size, p.batch_size_vispr, count=1)[0]
    v1, v2, clips, labels = (t.to(device, torch.float32) if t.is_floating_point() else t.to(device)
                             for t in inputs)
    gen = torch.Generator(device=device).manual_seed(0)
    opts = [make_optimizer(m.parameters(), p.opt_type, lr, p.weight_decay)
            for m, lr in ((fa, p.learning_rate_fa), (fb, p.learning_rate_fb), (ft, p.learning_rate_ft))]
    for remat, b in ADV_TIMED:
        q = p.replace(remat=remat)
        resolved = anon._resolve_remat(q, clips[:b].shape, v1.shape)
        steps = (("fa", anon.make_fa_step(fa, fb, ft, opts[0], q, device=device)),
                 ("fb/ft", anon.make_fbft_step(fa, fb, ft, opts[1], opts[2], q, generator=gen, device=device)))
        for name, step in steps:
            torch.cuda.reset_peak_memory_stats(device)
            ms = _timed_steps(lambda: step(v1, v2, clips[:b], labels[:b]), ADV_TIMED_STEPS)
            _step_line("adversarial", f"{name} step (remat {remat!r} -> {resolved!r}, {b} videos x 3 views "
                       f"x {p.num_frames} x {p.reso_h}^2 + {p.batch_size_vispr} VISPR pairs, "
                       f"{p.compute_dtype} autocast)", ms, b, "videos", device, card)
            if (remat, b) == ADV_TIMED[0]:
                log(f"[adversarial] where an {name} step's time goes:")
                profile_step(lambda: step(v1, v2, clips[:b], labels[:b]), steps=1)
    del fa, fb, ft, opts, v1, v2, clips
    torch.cuda.empty_cache()


def privacy_k2(device, card: str) -> None:
    """The privacy step's anonymized batch (32 augmented images of 224^2) through the
    bf16 plain-UNet fa with K2 and with its plain version: max |K2 - plain| within
    K2_BF16_TOL of max |plain|, and the error over the between-frame spread printed."""
    import torch

    from ted_spad_tpu_torch.config.params import PrivacyParams
    from ted_spad_tpu_torch.models import load_fa_model
    from ted_spad_tpu_torch.ops.augment import augment_batch

    pp = PrivacyParams()
    fa = load_fa_model("unet", seed=0, dtype=pp.compute_dtype, device=device)
    with torch.no_grad():
        fa.outc.weight.mul_(UNET_OUTC_GAIN)
    images, _, draw = _priv_batches(pp.batch_size, pp.reso_h, count=1)[0]
    with torch.inference_mode():
        x = augment_batch(torch.from_numpy(images).to(device)[:, None], draw, pp.reso_h, pp.reso_w)[:, 0]
        x = x.permute(0, 3, 1, 2)
        got = fa(x).double()
        ref = fa(x, use_kernel=False).double()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    spread = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref - ref.mean(0)))
    log(f"[privacy] the privacy batch ({pp.batch_size} images of {pp.reso_h}^2) through the bf16 UNet fa "
        f"(outc x{UNET_OUTC_GAIN}): K2 against its plain version max |d| {err:.3e} = {err / scale:.3e} of "
        f"max |plain| {scale:.4f} (limit {K2_BF16_TOL:.3e}); error / between-image spread {spread:.3e} | {card}")
    if not err <= K2_BF16_TOL * scale:
        raise AssertionError("K2 disagrees with its plain version on the privacy batch")


def privacy_drivers(device, workdir: str, card: str) -> tuple[dict, dict]:
    """The stage drivers end to end on synthetic sources: train_privacy (anon through
    the plain-UNet fa, so K2) and train_anonymizer (plain-UNet fa) for one short epoch
    each; checkpoints written and reloading bit-equal, finite losses; then the
    adversarially trained fa and ft serve (load_fa_model / load_ft_model -> the
    extraction step) and its fb loads in load_fb_model. Returns the kernels' launch
    counts from the train_privacy run and from the train_anonymizer run."""
    import numpy as np
    import torch

    from ted_spad_tpu_torch.config.params import (
        AnonymizationParams, FeatureExtractionParams, PrivacyParams,
    )
    from ted_spad_tpu_torch.data.images import SyntheticImageSource
    from ted_spad_tpu_torch.data.videos import synthetic_video_items
    from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model
    from ted_spad_tpu_torch.stages.anonymization_training import train_anonymizer
    from ted_spad_tpu_torch.stages.feature_extraction import make_extract_step
    from ted_spad_tpu_torch.stages.privacy_training import train_privacy

    root = os.path.join(workdir, "privacy")
    pp = PrivacyParams(anon=True, run_id="privacy_smoke")
    zero_launch_counts()
    t0 = time.perf_counter()
    res = train_privacy(pp, train_source=SyntheticImageSource(n=2 * pp.batch_size, seed=0),
                        val_source=SyntheticImageSource(n=pp.v_batch_size, seed=1), save_dir=root,
                        fa_arch="unet", max_epochs=1, log_fn=lambda m: log(f"[privacy] {m}"),
                        device=device)
    priv = launch_counts()
    log(f"[privacy] train_privacy (anon, plain-UNet fa): 2 steps of {pp.batch_size} + 1 validation batch in "
        f"{time.perf_counter() - t0:.1f}s, history {json.dumps(res['history'])}; kernel launches "
        f"{json.dumps(priv)} | {card}")
    h = res["history"]
    if not (all(len(v) == 1 for v in h.values()) and np.isfinite([v[0] for v in h.values()]).all()):
        raise AssertionError(f"train_privacy history out of range: {h}")
    if priv != expected(K2=9 * 3):
        raise AssertionError(f"expected K2 x27 (9 per fa forward, 2 train + 1 validation): {priv}")
    fb = load_fb_model(saved_model_file=res["best_path"], dtype="float32", device=device)
    if not _same_weights(fb, res["model"]):
        raise AssertionError("the privacy checkpoint does not reload bit-equal")

    n_videos, n_pairs = ADV_DRIVER
    ap = AnonymizationParams(arch_fa="unet", batch_size=n_videos, batch_size_vispr=n_pairs,
                             v_batch_size=2, num_modes=1, save_acc_threshold=-1.0, run_id="adv_smoke")
    zero_launch_counts()
    t0 = time.perf_counter()
    res = train_anonymizer(
        ap, train_items=synthetic_video_items(4 * n_videos, ap.num_classes, num_frames=64, h=240, w=320, seed=0),
        val_items=synthetic_video_items(2, ap.num_classes, num_frames=64, h=240, w=320, seed=1),
        vispr_source=SyntheticImageSource(n=4 * n_pairs, seed=0), save_dir=root, max_epochs=1,
        log_fn=lambda m: log(f"[adversarial] {m}"), device=device)
    adv = launch_counts()
    log(f"[adversarial] train_anonymizer (plain-UNet fa, {n_videos} videos + {n_pairs} VISPR pairs per batch, "
        f"4 batches at {ap.reso_h}^2): {time.perf_counter() - t0:.1f}s, history {json.dumps(res['history'])}; "
        f"kernel launches {json.dumps(adv)} | {card}")
    h = res["history"]
    if not (all(len(v) == 1 for v in h.values()) and np.isfinite([v[0] for v in h.values()]).all()):
        raise AssertionError(f"train_anonymizer history out of range: {h}")
    # 9 per eval fa forward: 2 fb/ft steps x 3 (two VISPR views, the clips), the
    # preview grid, one validation batch.
    if adv != expected(K2=9 * 8):
        raise AssertionError(f"expected K2 x72 on the adversarial path: {adv}")
    path = res["best_path"]
    fa32 = load_fa_model("unet", saved_model_file=path, dtype="float32", device=device)
    ft32 = load_ft_model(saved_model_file=path, dtype="float32", device=device)
    fb32 = load_fb_model(saved_model_file=path, ssl=True, dtype="float32", device=device)
    for name, trained, reloaded in (("fa", res["fa"], fa32), ("ft", res["ft"], ft32), ("fb", res["fb"], fb32)):
        if not _same_weights(trained, reloaded):
            raise AssertionError(f"the adversarial checkpoint's {name} does not reload bit-equal")
    del fa32, ft32, fb32
    p = FeatureExtractionParams(batch_size=4, arch_fa="unet")
    fa = load_fa_model("unet", saved_model_file=path, device=device)
    ft = load_ft_model(saved_model_file=path, device=device)
    batch = first_batch([f"synthetic://n=64,h=240,w=320,seed={s}" for s in range(2)], p, device)
    feats = make_extract_step(ft, p, fa, device=device)(batch)
    torch.cuda.synchronize(device)
    if not (feats.shape == (batch.shape[0], FEATURE_DIM) and bool(torch.isfinite(feats).all())):
        raise AssertionError(f"adversarially trained models' features: {tuple(feats.shape)}")
    log(f"[adversarial] checkpoint {os.path.getsize(path) / 1e6:.2f} MB (fa, fb, ft, flax msgpack) reloads "
        f"bit-equal; the trained UNet fa and ft extract one {batch.shape[0]}-clip batch through the serving "
        f"step: {tuple(feats.shape)} finite | {card}")
    return priv, adv


def _same_weights(a, b) -> bool:
    """Whether two modules hold bit-equal weights (their flax trees)."""
    import numpy as np

    from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax

    x, y = dict(_flat(state_dict_to_flax(a))), dict(_flat(state_dict_to_flax(b)))
    return x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)


def privacy_phase(device, workdir: str, card: str) -> tuple[dict, dict]:
    """Phase 13: the privacy side. Returns the kernels' launch counts from the
    train_privacy run and from the train_anonymizer run."""
    t0 = time.perf_counter()
    privacy_gate(device, card)
    privacy_steps(device, card)
    privacy_k2(device, card)
    launches = privacy_drivers(device, workdir, card)
    log(f"[privacy] phase time {time.perf_counter() - t0:.1f}s")
    return launches



def _png_rgb(path: str):
    """The (H, W, 3) uint8 pixels of an 8-bit RGB PNG with unfiltered rows, as
    stages/visualization.write_png writes it (no image library on the card's machine)."""
    import struct
    import zlib

    import numpy as np

    data = open(path, "rb").read()
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: filtered PNG rows")
    return rows[:, 1:].reshape(h, w, 3)


@contextlib.contextmanager
def _recorded_frames():
    """The visualization stage's writers (mp4 and y4m) made to keep a copy of every
    frame they are given, in order, besides writing it; yields that list."""
    import numpy as np

    from ted_spad_tpu_torch.stages import visualization as vis

    frames, saved = [], (vis.VideoWriter, vis.Y4MWriter)

    def recording(base):
        class Recording(base):
            def write(self, frame):
                frames.append(np.array(frame))
                super().write(frame)
        return Recording

    vis.VideoWriter, vis.Y4MWriter = recording(saved[0]), recording(saved[1])
    try:
        yield frames
    finally:
        vis.VideoWriter, vis.Y4MWriter = saved


def _vis_run(device, workdir: str, tag: str, card: str, **kw) -> dict:
    """anonymize_video on VIS_VIDEO with ``kw``: its paths, the anonymized uint8 frames
    it wrote, the kernels' launches, its writer (from its log line), wall time and peak
    device memory, printed."""
    import numpy as np
    import torch

    from ted_spad_tpu_torch.stages.visualization import anonymize_video

    said = []
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    with _recorded_frames() as frames:
        t0 = time.perf_counter()
        paths = anonymize_video(VIS_VIDEO, os.path.join(workdir, "vis", tag), log_fn=said.append,
                                device=device, **kw)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    launches = launch_counts()
    writer = "mp4" if paths["video"].endswith(".mp4") else "y4m"
    run = {"paths": paths, "frames": np.stack(frames), "launches": launches, "writer": writer,
           "seconds": seconds, "peak": torch.cuda.max_memory_allocated(device)}
    n = VIS_FRAMES
    log(f"[vis] {tag}: {n} frames of {VIS_VIDEO} in {seconds * 1e3:.1f} ms = {seconds * 1e3 / n:.3f} "
        f"ms/frame = {n / seconds:.2f} frames/s (decode, fa, writer and grid; host clock), peak "
        f"device memory {run['peak'] / 2**20:.1f} MiB, writer {writer} ({said[0]}), kernel "
        f"launches {json.dumps(launches)} | {card}")
    return run


def _level_gap(a, b) -> tuple[int, float]:
    """(max |a - b|, share of values that differ) of two uint8 frame stacks."""
    d = abs(a.astype(int) - b.astype(int))
    return int(d.max()), float((d > 0).mean())


def _spread_error(x, ref) -> float:
    """||x - ref|| / ||ref - mean frame of ref|| over uint8 frame stacks."""
    import numpy as np

    x, ref = x.astype(np.float64), ref.astype(np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref - ref.mean(0)))


def k2_float32_chunk(device, card: str) -> dict:
    """K2's float32 form (CUDA-core FMAs, the default visualization's) at the nine
    DoubleConvs of one VIS_CHUNK chunk, each beside its device-only reading, its plain
    version and the cuDNN float32 conv + bias + ReLU pair (TF32 off for both) and its
    bound: 2*9*(Cin*Cmid + Cmid*Cout) FLOP per pixel at the float32 FMA peak, or x, the
    output, the weights and biases moved once at the memory rate."""
    import torch

    from ted_spad_tpu_torch.chip_probes import (
        VIS_CHUNK, double_conv_operands, time_ms, unet_doubleconv_shapes,
    )
    from ted_spad_tpu_torch.ops import doubleconv as dc
    from ted_spad_tpu_torch.utils.device import tf32_off

    n = VIS_CHUNK[0]
    shapes, worst = [], 0.0
    for i, (name, h, w, ci, cm, co) in enumerate(unet_doubleconv_shapes(*VIS_CHUNK[1:])):
        x, w1, b1, w2, b2 = double_conv_operands(device, (n, h, w, ci, cm, co), torch.float32, seed=50 + i)
        got = dc.fused_double_conv(x, w1, b1, w2, b2)
        with tf32_off():
            ref = dc.double_conv_reference(x, w1, b1, w2, b2)
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        worst = max(worst, err)
        ms, plain_ms, library_ms = _k2_times(x, w1, b1, w2, b2)
        device_ms = time_ms(lambda: dc.fused_double_conv(x, w1, b1, w2, b2), reps=3, inner=1, queued=True)
        flops = 2 * n * h * w * 9 * (ci * cm + cm * co)
        by_ops = flops / F32_FLOPS * 1e3
        by_bytes = 4 * (n * h * w * (ci + co) + 9 * (ci * cm + cm * co) + cm + co) / HBM_BYTES_PER_S * 1e3
        shapes.append({"block": name, "shape": [h, w, ci, cm, co], "ms": ms, "device_only_ms": device_ms,
                       "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": max(by_ops, by_bytes),
                       "flops": flops, "max_rel_err": err})
        log(f"[K2 f32] {name} {h}x{w} {ci}->{cm}->{co} x{n} float32: max|kernel - plain| {err:.3e} of "
            f"max|plain| (limit {K2_F32_TOL:.0e}); kernel {ms:.3f} ms ({device_ms:.3f} device-only, "
            f"{flops / device_ms * 1e-9:.1f} TFLOP/s), plain {plain_ms:.3f}, cuDNN f32 pair {library_ms:.3f}, "
            f"bound {max(by_ops, by_bytes):.3f} ms ({'operations' if by_ops >= by_bytes else 'bytes'})")
        del x, w1, w2, got, ref
        if not err <= K2_F32_TOL:
            raise AssertionError(f"K2's float32 form disagrees with its plain version at {name}: {err}")
    total = {k: sum(r[k] for r in shapes) for k in ("ms", "device_only_ms", "plain_ms", "library_ms", "bound_ms",
                                                     "flops")}
    log(f"[K2 f32] the nine DoubleConvs of one {n}-frame {VIS_CHUNK[1]}x{VIS_CHUNK[2]} chunk, float32: kernel {total['ms']:.3f} ms "
        f"({total['device_only_ms']:.3f} device-only), plain {total['plain_ms']:.3f}, cuDNN f32 pairs "
        f"{total['library_ms']:.3f}, bound {total['bound_ms']:.3f} ms ({total['flops'] / 1e12:.3f} TFLOP at "
        f"{F32_FLOPS / 1e12:.0f} TFLOP/s; {total['flops'] / n / 1e9:.2f} GFLOP per frame), "
        f"{total['ms'] / total['bound_ms']:.1f}x the bound | {card}")
    return {"frames": n, "frame": list(VIS_CHUNK[1:]), "dtype": "float32", **total, "bound_by": "operations",
            "max_rel_err": worst, "shapes": shapes}


def visualization_phase(device, workdir: str, card: str) -> tuple[dict, dict]:
    """Phase 14: the visualization stage at full width. Returns (K2's float32 reading at
    the chunk, the kernels' launches by run)."""
    import subprocess as sp

    import numpy as np
    import torch

    from ted_spad_tpu_torch.data.video_reader import VideoReader, open_video
    from ted_spad_tpu_torch.models import load_fa_model
    from ted_spad_tpu_torch.stages.visualization import make_anonymize_fn

    t0 = time.perf_counter()
    frames_in = open_video(VIS_VIDEO).read_strided(0, VIS_FRAMES, 1)
    launches = {}

    # UNet++ at the stage's defaults (float32; the stage loads the seeded fa itself).
    upp = _vis_run(device, workdir, "unet++", card)
    launches["visualization unet++"] = upp["launches"]
    if upp["launches"] != expected():
        raise AssertionError(f"the UNet++ visualization launched a kernel: {upp['launches']}")
    fa_cpu = load_fa_model(dtype="float32", device="cpu")
    cpu_anon = make_anonymize_fn(fa_cpu)
    to_u8 = lambda out: (out * 255.0 + 0.5).to(torch.uint8).cpu().numpy()  # noqa: E731
    cpu = to_u8(cpu_anon(frames_in[:2 * VIS_CPU_FRAMES]))
    gap = _level_gap(upp["frames"][:VIS_CPU_FRAMES], cpu[:VIS_CPU_FRAMES])
    controls = {"next frames": _level_gap(upp["frames"][:VIS_CPU_FRAMES], cpu[VIS_CPU_FRAMES:]),
                "R/B swapped": _level_gap(upp["frames"][:VIS_CPU_FRAMES],
                                          to_u8(cpu_anon(frames_in[:VIS_CPU_FRAMES, :, :, ::-1].copy())))}
    del fa_cpu
    log(f"[vis] UNet++ frames 0-{VIS_CPU_FRAMES - 1}, card against the CPU's float32 stage: max |d| {gap[0]} "
        f"levels, {gap[1]:.2e} of values differ (limit {VIS_LEVEL_TOL} level); controls (max |d|, share): "
        f"{json.dumps(controls)}")
    if not gap[0] <= VIS_LEVEL_TOL:
        raise AssertionError(f"the card's UNet++ visualization disagrees with the CPU's: {gap}")
    if not all(c[0] > VIS_LEVEL_TOL for c in controls.values()):
        raise AssertionError(f"the UNet++ visualization gate does not tell its controls apart: {controls}")

    # The plain UNet: K2's float32 form, against the same stage through the plain DoubleConv.
    fa = load_fa_model("unet", dtype="float32", device=device)
    with torch.no_grad():
        fa.outc.weight.mul_(UNET_OUTC_GAIN)
    unet = _vis_run(device, workdir, "unet", card, fa=fa)
    plain = _vis_run(device, workdir, "unet plain", card, fa=_PlainDoubleConvs(fa))
    launches["visualization unet"] = unet["launches"]
    chunks = -(-VIS_FRAMES // VIS_CHUNK_FRAMES)
    if unet["launches"] != expected(K2=9 * chunks) or plain["launches"] != expected():
        raise AssertionError(f"expected K2 x{9 * chunks} on the UNet visualization and none on its plain "
                             f"run: {unet['launches']}, {plain['launches']}")
    c = VIS_CHUNK_FRAMES
    swapped = to_u8(make_anonymize_fn(_PlainDoubleConvs(fa))(frames_in[:c, :, :, ::-1].copy()))
    gap = _level_gap(unet["frames"], plain["frames"])
    controls = {"R/B swapped": _level_gap(unet["frames"][:c], swapped),
                "next chunk": _level_gap(unet["frames"][:c], plain["frames"][c:2 * c])}
    log(f"[vis] UNet (outc x{UNET_OUTC_GAIN}) float32, K2 against the stage through the plain DoubleConv "
        f"(TF32 off), {VIS_FRAMES} frames: max |d| {gap[0]} levels, {gap[1]:.2e} of values differ (limits "
        f"{VIS_LEVEL_TOL} level, {VIS_DIFF_SHARE:.0e}); controls (max |d|, share): {json.dumps(controls)}")
    if not (gap[0] <= VIS_LEVEL_TOL and gap[1] <= VIS_DIFF_SHARE):
        raise AssertionError(f"the K2 UNet visualization disagrees with the plain one: {gap}")
    if not all(x[0] > VIS_LEVEL_TOL and x[1] > VIS_DIFF_SHARE for x in controls.values()):
        raise AssertionError(f"the UNet visualization gate does not tell its controls apart: {controls}")

    # bf16: K2's bf16 form, held to the fa-fidelity limit against the float32 plain frames.
    fa16 = load_fa_model("unet", dtype="bfloat16", device=device)
    with torch.no_grad():
        fa16.outc.weight.mul_(UNET_OUTC_GAIN)
    bf16 = _vis_run(device, workdir, "unet bf16", card, fa=fa16)
    launches["visualization unet bf16"] = bf16["launches"]
    if bf16["launches"] != expected(K2=9 * chunks):
        raise AssertionError(f"expected K2 x{9 * chunks} on the bf16 UNet visualization: {bf16['launches']}")
    err = _spread_error(bf16["frames"], plain["frames"])
    controls = {"R/B swapped": _spread_error(swapped, plain["frames"][:c]),
                "previous chunk": _spread_error(plain["frames"][:c], plain["frames"][c:2 * c])}
    log(f"[vis] UNet bf16 (K2's bf16 form) against the float32 plain frames: error / between-frame spread "
        f"{err:.6f} (limit {FIDELITY_SPREAD_MAX}); controls {json.dumps(controls)} | {card}")
    if not err <= FIDELITY_SPREAD_MAX:
        raise AssertionError("the bf16 UNet visualization drifts from the float32 plain one")
    if not all(x > FIDELITY_SPREAD_MAX for x in controls.values()):
        raise AssertionError(f"the bf16 fidelity limit does not reject its controls: {controls}")
    del fa, fa16
    torch.cuda.empty_cache()

    # The written files: the grid (originals over anonymized frames), and the mp4 read back.
    idx = np.linspace(0, VIS_FRAMES - 1, 4).astype(int)
    for run in (upp, unet):
        grid = _png_rgb(run["paths"]["grid"])
        want = np.concatenate([np.concatenate(list(frames_in[idx]), axis=1),
                               np.concatenate(list(run["frames"][idx]), axis=1)], axis=0)
        if not np.array_equal(grid, want):
            raise AssertionError(f"{run['paths']['grid']} does not hold the originals over the anonymized frames")
        if run["writer"] == "mp4":
            with VideoReader(run["paths"]["video"]) as v:
                decoded = v.read_strided(0, len(v), 1)
            mean = float(np.abs(np.concatenate(list(decoded[idx]), axis=1).astype(int)
                                - want[frames_in.shape[1]:].astype(int)).mean())
            log(f"[vis] {os.path.basename(run['paths']['video'])}: {len(decoded)} frames decoded by the port's "
                f"reader, mean |d| to the grid's anonymized row {mean:.3f} levels (limit {VIS_MP4_MEAN})")
            if not (len(decoded) == VIS_FRAMES and mean < VIS_MP4_MEAN):
                raise AssertionError(f"the written mp4 does not read back: {len(decoded)} frames, mean {mean}")

    out = sp.run([sys.executable, "-m", "ted_spad_tpu_torch.visualize_anonymization", "--synthetic", "--out_dir",
                  os.path.join(workdir, "vis_cli")], cwd=ROOT, capture_output=True, text=True, timeout=300,
                 env={**os.environ, "PYTHONPATH": ROOT})
    made = sorted(os.listdir(os.path.join(workdir, "vis_cli"))) if out.returncode == 0 else []
    log(f"[vis] python -m ted_spad_tpu_torch.visualize_anonymization --synthetic (default device): rc "
        f"{out.returncode}, wrote {made}; {out.stdout.strip().splitlines()[-1:] or out.stderr[-400:]}")
    if out.returncode != 0 or len(made) != 2:
        raise AssertionError(f"the visualization CLI failed: {out.stderr[-2000:]}")

    chunk = k2_float32_chunk(device, card)
    chunk["launches"] = unet["launches"]["K2 double_conv"]
    log(f"[vis] phase time {time.perf_counter() - t0:.1f}s")
    return chunk, launches


class _PlainDoubleConvs:
    """A plain-UNet fa called with ``use_kernel=False``: its DoubleConvs through the plain
    version (float32 convs), the rest as the fa; for the visualization stage's ``fa``."""

    def __init__(self, fa):
        self.fa = fa

    def parameters(self):
        return self.fa.parameters()

    def __call__(self, x):
        return self.fa(x, use_kernel=False)


def _family_gate(device, family: str, card: str) -> None:
    """Phase 15's gate for one ft family: the action step, the adversarial fa step and
    fb/ft step on the card in float64 (remat "on" for the adversarial steps) against a
    float64 reference step from the same seeded weights, batch and draw, TF32 off,
    dropout 0, held to phase 12's limits; the card's float32 loss printed beside them;
    the card's float32 step on another batch the control, which must exceed each limit
    (the BN statistics' where the step moves any). The action step's reference is the
    CPU's, which holds each family against the CPU once; the adversarial steps' is the
    card's own under remat "off" (their CPU float64 steps through the full-width UNet++
    were most of the phase's time; phase 13 holds those steps against the CPU with the
    I3Res50 ft)."""
    import torch

    from ted_spad_tpu_torch.config.params import ActionParams, AnonymizationParams
    from ted_spad_tpu_torch.data.videos import ClipDataset, synthetic_video_items

    n, (t, h, w) = FT_GATE[family]
    p = ActionParams(arch=family, num_frames=t, reso_h=h, reso_w=w, temporal_loss="trip", loss="ce",
                     batch_size=n, compute_dtype="float32")
    m = max(n, 2)
    ds = ClipDataset(synthetic_video_items(2 * m, p.num_classes, num_frames=64, h=240, w=320, seed=0), p,
                     views=3, num_workers=4, seed=0)
    try:
        action = [(_first_videos(b, n),) for b in list(ds.batches(m, seed=1))[:2]]
    finally:
        ds.close()
    base = dict(arch_ft=family, num_frames=t, reso_h=h, reso_w=w, compute_dtype="float32")
    p_on, p_off = AnonymizationParams(**base, remat="on"), AnonymizationParams(**base, remat="off")
    adv = _adv_inputs(p_on, n, FT_GATE_PAIRS)
    # (name, step(device, dtype, batch, remat on), batches, the reference step's device)
    cases = (("action", lambda d, dt, b, on: _ft_gate_step(d, dt, p, *b), action, "cpu"),
             ("fa", lambda d, dt, b, on: _adv_gate_step(d, dt, "fa", p_on if on else p_off, b), adv, device),
             ("fb/ft", lambda d, dt, b, on: _adv_gate_step(d, dt, "fbft", p_on if on else p_off, b), adv,
              device))

    f64 = torch.float64
    for name, run, batches, ref_device in cases:
        t0 = time.perf_counter()
        ref = run(ref_device, f64, batches[0], False)
        card64 = _step_against(ref, run(device, f64, batches[0], True))
        card32 = _step_against(ref, run(device, torch.float32, batches[0], True))
        control = _step_against(ref, run(device, torch.float32, batches[1], True))
        where = "the CPU's" if ref_device == "cpu" else "the card's remat-off"
        log(f"[ft] {family} {name} step ({n} video{'s' * (n > 1)} x 3 views x {t} x {h}x{w}"
            f"{f' + {FT_GATE_PAIRS} VISPR pairs' if name != 'action' else ''}) against {where} float64 step "
            f"(TF32 off, dropout 0{', card remat on' if name != 'action' else ''}): card float64 "
            f"{show_step(card64)}; card float32 loss rel {card32['loss']:.3e} (limits: loss "
            f"{TRAIN_LOSS_RTOL}, gradients {TRAIN_GRAD_RTOL}, statistics {TRAIN_STATS_RTOL}); control, the card's "
            f"float32 step on another batch: {show_step(control)}; {time.perf_counter() - t0:.1f}s | {card}")
        if not (card64["loss"] <= TRAIN_LOSS_RTOL and card64["stats"][0] <= TRAIN_STATS_RTOL
                and card64["null"][1] <= TRAIN_NULL_GRAD and card64["grad"][0] <= TRAIN_GRAD_RTOL):
            raise AssertionError(f"the card's float64 {family} {name} step disagrees with {where}")
        has_stats = bool(ref[2])
        if not (control["loss"] > TRAIN_LOSS_RTOL and control["grad"][0] > TRAIN_GRAD_RTOL
                and (not has_stats or control["stats"][0] > TRAIN_STATS_RTOL)):
            raise AssertionError(f"the {family} {name} step gate does not tell another batch apart")


def _timed_with_cuts(make_step, batch: int, what, card: str) -> int:
    """Time ``make_step(b)``'s step (1 warm-up, FT_TIMED_STEPS timed, CUDA events) at
    ``batch``, halving the batch while it runs out of memory; prints ms, videos/s, peak
    memory and the busy share of one profiled step. Returns the batch that ran."""
    import torch

    from ted_spad_tpu_torch.chip_probes import device_profile

    b = batch
    while b >= 1:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            step = make_step(b)
            ms = _timed_steps(step, FT_TIMED_STEPS)
            peak = torch.cuda.max_memory_allocated()
            prof = device_profile(step, 1)
        except torch.cuda.OutOfMemoryError:
            log(f"[ft] {what(b)}: out of the card's memory; halving the batch")
            step = None
            b //= 2
            continue
        mean = sum(ms) / len(ms)
        top = ", ".join(f"{k[:48]} {v:.2f}" for k, v in prof["kernels"][:3])
        log(f"[ft] {what(b)}{'' if b == batch else f' (cut from {batch})'}: steps "
            f"{json.dumps([round(x, 3) for x in ms])} ms, mean {mean:.3f} ms/step = {b * 1e3 / mean:.2f} "
            f"videos/s, peak device memory {peak / 2**20:.1f} MiB, device {prof['device_ms']:.3f} ms/step, "
            f"busy {prof['busy']:.3f} (top kernels ms: {top}) | {card}")
        return b
    raise AssertionError(f"{what(1)} does not fit in the card's memory")


def ft_step_inputs(device) -> tuple:
    """The timed steps' inputs, the same for every family: one training batch at
    ActionParams' defaults ('trip': 16 videos x 3 views, uint8, with its draw) and one
    adversarial batch at AnonymizationParams' (8 videos x 3 views + 12 VISPR pairs,
    augmented, float32 on the card)."""
    import torch

    from ted_spad_tpu_torch.config.params import ActionParams, AnonymizationParams
    from ted_spad_tpu_torch.data.videos import ClipDataset, synthetic_video_items

    p = ActionParams(temporal_loss="trip")
    items = synthetic_video_items(p.batch_size, p.num_classes, num_frames=64, h=240, w=320, seed=0)
    ds = ClipDataset(items, p, views=3, num_workers=8, seed=0)
    try:
        batch = next(ds.batches(p.batch_size))
    finally:
        ds.close()
    q = AnonymizationParams()
    adv = tuple(x.to(device, torch.float32) if x.is_floating_point() else x.to(device)
                for x in _adv_inputs(q, q.batch_size, q.batch_size_vispr, count=1)[0])
    return batch, adv


def ft_family_steps(device, family: str, inputs: tuple, card: str) -> dict:
    """The full-width bf16 steps with one ft family, timed on ``inputs``
    (``ft_step_inputs``): the action step at ActionParams' defaults ('trip', 16 videos x
    3 views of 16 x 224^2, dropout 0.5 for i3d) and the adversarial fa and fb/ft steps at
    AnonymizationParams' (8 videos x 3 views + 12 VISPR pairs, remat "auto"). Returns
    the batches that ran."""
    import torch

    from ted_spad_tpu_torch.config.params import ActionParams, AnonymizationParams
    from ted_spad_tpu_torch.models import load_ft_model
    from ted_spad_tpu_torch.ops.augment import AugmentParams
    from ted_spad_tpu_torch.stages import action_training
    from ted_spad_tpu_torch.stages import anonymization_training as anon
    from ted_spad_tpu_torch.stages.common import make_optimizer

    batch, (v1, v2, clips, labels) = inputs
    p = ActionParams(arch=family, temporal_loss="trip")
    ft = load_ft_model(family, seed=0, dtype="float32", device=device, num_classes=p.num_classes,
                       clip_shape=(p.num_frames, p.reso_h, p.reso_w),
                       dropout_rate=p.ft_dropout or None).requires_grad_(True)
    opt = make_optimizer(ft.parameters(), p.opt_type, p.learning_rate, p.weight_decay, p.momentum)
    step = action_training.make_train_step(ft, opt, p, generator=torch.Generator(device=device).manual_seed(0),
                                           device=device)
    raw = torch.from_numpy(batch.clips).to(device)

    def action_step(b):
        draw = AugmentParams(**{k: v[:b * 3] for k, v in vars(batch.params).items()})
        return lambda: step(raw[:b], batch.labels[:b], draw)

    ran = {"action": _timed_with_cuts(action_step, p.batch_size, lambda b: (
        f"{family} action step ({b} videos x 3 'trip' views of {p.num_frames} x {p.reso_h}^2, "
        f"{p.compute_dtype} autocast, dropout {p.ft_dropout or 'module default'})"), card)}
    del ft, opt, step, raw
    torch.cuda.empty_cache()

    q = AnonymizationParams(arch_ft=family)
    fa, fb, ft = _adv_models(device, torch.float32, q, dropout_rate=None)
    opts = [make_optimizer(m.parameters(), q.opt_type, lr, q.weight_decay)
            for m, lr in ((fa, q.learning_rate_fa), (fb, q.learning_rate_fb), (ft, q.learning_rate_ft))]
    steps = {"fa": anon.make_fa_step(fa, fb, ft, opts[0], q, device=device),
             "fb/ft": anon.make_fbft_step(fa, fb, ft, opts[1], opts[2], q, device=device,
                                          generator=torch.Generator(device=device).manual_seed(0))}
    for which, adv_step in steps.items():
        ran[which] = _timed_with_cuts(
            lambda b, adv_step=adv_step: (lambda: adv_step(v1, v2, clips[:b], labels[:b])), q.batch_size,
            lambda b, which=which: (
                f"{family} adversarial {which} step ({b} videos x 3 views x {q.num_frames} x {q.reso_h}^2 + "
                f"{q.batch_size_vispr} VISPR pairs, remat 'auto' -> "
                f"{anon._resolve_remat(q, clips[:b].shape, v1.shape)!r}, {q.compute_dtype} autocast)"), card)
    del fa, fb, ft, opts, steps
    torch.cuda.empty_cache()
    return ran


def ft_family_drivers(device, workdir: str, card: str) -> dict:
    """train_action with the R3D-18 ft and train_anonymizer with the InceptionI3d ft
    (UNet++ fa), one epoch of FT_DRIVER_STEPS steps each on synthetic data; finite
    histories, checkpoints reloading bit-equal. Returns the kernels' launches from both
    runs (none expected)."""
    import numpy as np

    from ted_spad_tpu_torch.config.params import ActionParams, AnonymizationParams
    from ted_spad_tpu_torch.data.images import SyntheticImageSource
    from ted_spad_tpu_torch.data.videos import synthetic_video_items
    from ted_spad_tpu_torch.models import load_ft_model
    from ted_spad_tpu_torch.stages.action_training import train_action
    from ted_spad_tpu_torch.stages.anonymization_training import train_anonymizer

    root = os.path.join(workdir, "ft_families")
    ap = ActionParams(arch="r3d_18", temporal_loss="trip", batch_size=4, v_batch_size=8, num_modes=1,
                      run_id="r3d_smoke")
    n_videos, n_pairs = ADV_DRIVER
    qp = AnonymizationParams(arch_ft="i3d", batch_size=n_videos, batch_size_vispr=n_pairs, v_batch_size=2,
                             num_modes=1, save_acc_threshold=-1.0, run_id="i3d_adv_smoke")
    zero_launch_counts()
    t0 = time.perf_counter()
    act = train_action(ap, train_items=synthetic_video_items(ap.batch_size * FT_DRIVER_STEPS, ap.num_classes,
                                                             num_frames=64, h=240, w=320, seed=0),
                       val_items=synthetic_video_items(8, ap.num_classes, num_frames=64, h=240, w=320, seed=1),
                       save_dir=root, max_epochs=1, log_fn=lambda m: log(f"[ft] {m}"), device=device)
    t1 = time.perf_counter()
    adv = train_anonymizer(
        qp, train_items=synthetic_video_items(n_videos * FT_DRIVER_STEPS, qp.num_classes, num_frames=64, h=240,
                                              w=320, seed=0),
        val_items=synthetic_video_items(2, qp.num_classes, num_frames=64, h=240, w=320, seed=1),
        vispr_source=SyntheticImageSource(n=n_pairs * FT_DRIVER_STEPS, seed=0), save_dir=root, max_epochs=1,
        log_fn=lambda m: log(f"[ft] {m}"), device=device)
    launches = launch_counts()
    log(f"[ft] train_action (r3d_18, 'trip', {FT_DRIVER_STEPS} steps of {ap.batch_size} videos) {t1 - t0:.1f}s, "
        f"history {json.dumps(act['history'])}; train_anonymizer (i3d ft, UNet++ fa, {FT_DRIVER_STEPS} batches of "
        f"{n_videos} videos + {n_pairs} pairs) {time.perf_counter() - t1:.1f}s, history "
        f"{json.dumps(adv['history'])}; kernel launches {json.dumps(launches)} | {card}")
    for h in (act["history"], adv["history"]):
        if not (all(len(v) == 1 for v in h.values()) and np.isfinite([v[0] for v in h.values()]).all()):
            raise AssertionError(f"a driver's history is out of range: {h}")
    for path, trained, arch, classes in ((act["best_path"], act["model"], "r3d_18", ap.num_classes),
                                         (adv["best_path"], adv["ft"], "i3d", qp.num_classes)):
        reloaded = load_ft_model(arch, saved_model_file=path, num_classes=classes, dtype="float32", device=device)
        if not _same_weights(trained, reloaded):
            raise AssertionError(f"the {arch} driver's checkpoint does not reload bit-equal")
    return launches


def ft_families_phase(device, workdir: str, card: str) -> dict:
    """Phase 15: the InceptionI3d, R3D-18 and MViTv2-S fts in action training and in the
    adversarial stage. Returns the kernels' launch counts from the drivers' run."""
    t0 = time.perf_counter()
    for family in FT_FAMILIES:
        _family_gate(device, family, card)
    inputs = ft_step_inputs(device)
    for family in FT_FAMILIES:
        ft_family_steps(device, family, inputs, card)
    del inputs
    launches = ft_family_drivers(device, workdir, card)
    if any(launches.values()):
        raise AssertionError(f"the ft families' drivers launched a kernel: {launches}")
    log(f"[ft] phase time {time.perf_counter() - t0:.1f}s")
    return launches


def _dp_record(losses, models: dict) -> dict:
    """A step's readings, float64 on the CPU: its losses, every gradient and the
    trained models' state after the optimizer (parameters and buffers), by name."""
    import torch

    grads, state = {}, {}
    for name, m in models.items():
        grads.update({f"{name}.{k}": q.grad.double().cpu() for k, q in m.named_parameters()})
        state.update({f"{name}.{k}": t.detach().double().cpu() for k, t in m.state_dict().items()
                      if t.is_floating_point()})
    return {"losses": torch.as_tensor(losses).detach().double().cpu().reshape(-1),
            "grads": grads, "state": state}


def _dp_params() -> dict:
    """The configurations of phase 16's steps."""
    from ted_spad_tpu_torch.config.params import ActionParams, AnonymizationParams, MGFNParams

    n, t, side = DP_ACTION
    nv, npairs, ta, sa = DP_ADV
    return {
        "mgfn": MGFNParams.for_dataset("UCF", dropout_rate=0.0, batch_size=DP_MGFN_BATCH),
        "action": ActionParams(num_frames=t, reso_h=side, reso_w=side, temporal_loss="trip", loss="ce",
                               batch_size=n, compute_dtype="float32"),
        "adversarial": AnonymizationParams(num_frames=ta, reso_h=sa, reso_w=sa, batch_size=nv,
                                           batch_size_vispr=npairs, accum_steps=DP_ACCUM,
                                           remat="off", compute_dtype="float32"),
    }


def dp_step(device, which: str, inputs: dict, mesh, dtype):
    """Phase 16's ``which`` step ('mgfn', 'action', 'fa', 'fbft') from the seeded
    full-width models in ``dtype`` on ``inputs`` (the global batch; with ``mesh`` this
    rank's rows of it, in the adversarial stage's microbatch layout): a callable that
    runs one step (TF32 off, dropout 0) and returns the losses, and the trained models."""
    import torch

    from ted_spad_tpu_torch.chip_probes import perturbed_mgfn
    from ted_spad_tpu_torch.models import load_ft_model
    from ted_spad_tpu_torch.stages import action_training
    from ted_spad_tpu_torch.stages import anonymization_training as anon
    from ted_spad_tpu_torch.stages.anomaly_detection import make_optimizer as mgfn_optimizer
    from ted_spad_tpu_torch.stages.anomaly_detection import make_train_step as mgfn_train_step
    from ted_spad_tpu_torch.stages.common import make_optimizer
    from ted_spad_tpu_torch.utils.device import tf32_off

    params = _dp_params()
    if which == "mgfn":
        p = params["mgfn"]
        model = perturbed_mgfn(p, device, dtype=dtype)
        step = mgfn_train_step(model, mgfn_optimizer(model, p), p, device=device, mesh=mesh)
        batch = inputs["mgfn"] if mesh is None else [mesh.take_rows(x) for x in inputs["mgfn"]]
        return (lambda: step(*batch)), {"mgfn": model}
    if which == "action":
        p = params["action"]
        model = load_ft_model(p.arch, seed=0, dtype="float32", device=device, num_classes=p.num_classes,
                              dropout_rate=0.0, clip_shape=(p.num_frames, p.reso_h, p.reso_w))
        model = model.to(dtype).requires_grad_(True)
        opt = make_optimizer(model.parameters(), p.opt_type, p.learning_rate, p.weight_decay, p.momentum)
        step = action_training.make_train_step(model, opt, p, device=device, mesh=mesh)
        clips, labels, draw = inputs["action"]
        if mesh is not None:
            draw = mesh.take_rows(draw, len(clips))  # a clip's three views are consecutive rows
            clips, labels = mesh.take_rows(clips), mesh.take_rows(labels)

        def run():
            with tf32_off():
                return step(clips, labels, draw)
        return run, {"ft": model}
    p = params["adversarial"]
    fa, fb, ft = _adv_models(device, dtype, p)
    batch = inputs["adversarial"]
    if mesh is not None:
        batch = [mesh.take_rows(x, parts=p.accum_steps) for x in batch]
    v1, v2, clips, labels = (t.to(device, dtype) if t.is_floating_point() else t.to(device) for t in batch)
    if which == "fa":
        step = anon.make_fa_step(fa, fb, ft, make_optimizer(fa.parameters(), "adam", 1e-3), p,
                                 device=device, mesh=mesh)
        trained = {"fa": fa}
    else:
        step = anon.make_fbft_step(fa, fb, ft, make_optimizer(fb.parameters(), "adam", 1e-3),
                                   make_optimizer(ft.parameters(), "adam", 1e-3), p,
                                   generator=torch.Generator(device=device).manual_seed(0),
                                   device=device, mesh=mesh)
        trained = {"fb": fb, "ft": ft}

    def run_adv():
        with tf32_off():
            return step(v1, v2, clips, labels)
    return run_adv, trained


DP_STEPS = ("mgfn", "action", "fa", "fbft")


def dp_run(device, inputs: dict, mesh) -> dict:
    """Each of phase 16's steps from its seeded models: once in float64, then in float32
    (the first float32 step is the reading and the warm-up; DP_TIMED_STEPS more timed,
    host clock around a synchronized step; with a mesh one more whose collectives, each
    synchronized and timed, give their share of it). {"float64": {step: record},
    "float32": {step: record}, "times": {step: (mean ms, collectives' share or None)}}."""
    import torch
    import torch.distributed as dist

    out = {"float64": {}, "float32": {}, "times": {}}
    for which in DP_STEPS:
        for dtype in (torch.float64, torch.float32):
            run, models = dp_step(device, which, inputs, mesh, dtype)
            out[str(dtype).split(".")[1]][which] = _dp_record(run(), models)
            if dtype == torch.float64:
                continue
            ms = []
            for _ in range(DP_TIMED_STEPS):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize(device)
                ms.append((time.perf_counter() - t0) * 1e3)
            share = None
            if mesh is not None:
                spent = [0.0]
                saved = {name: getattr(dist, name) for name in ("all_reduce", "all_gather", "broadcast")}

                def timed(fn):
                    def call(*a, **k):
                        torch.cuda.synchronize(device)
                        t0 = time.perf_counter()
                        try:
                            return fn(*a, **k)
                        finally:
                            torch.cuda.synchronize(device)
                            spent[0] += time.perf_counter() - t0
                    return call

                for name, fn in saved.items():
                    setattr(dist, name, timed(fn))
                try:
                    torch.cuda.synchronize(device)
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize(device)
                    share = spent[0] / (time.perf_counter() - t0)
                finally:
                    for name, fn in saved.items():
                        setattr(dist, name, fn)
            out["times"][which] = (sum(ms) / len(ms), share)
        del run, models
        torch.cuda.empty_cache()
    return out


def dp_kernel_paths(device, workdir: str, mesh) -> dict:
    """The kernels' launches on this rank's data-parallel paths: extract_features(mesh=)
    over DP_EXTRACT_VIDEOS synthetic serving videos with the UNet++ fa (K1) and with the
    plain UNet (K1, and K2 for its DoubleConvs), and train_anonymizer(mesh=) with the plain-UNet fa for one epoch of two
    batches (a fa step and a fb/ft step). {path: launch counts}."""
    import numpy as np

    from ted_spad_tpu_torch.config.params import AnonymizationParams, FeatureExtractionParams
    from ted_spad_tpu_torch.data.images import SyntheticImageSource
    from ted_spad_tpu_torch.data.videos import synthetic_video_items
    from ted_spad_tpu_torch.stages.anonymization_training import train_anonymizer
    from ted_spad_tpu_torch.stages.feature_extraction import extract_features

    uris = [f"synthetic://n={SERVING_FRAMES},h=240,w=320,seed={100 + i}" for i in range(DP_EXTRACT_VIDEOS)]
    out = {}
    for arch in ("unet++", "unet"):
        zero_launch_counts()
        res = extract_features(FeatureExtractionParams(arch_fa=arch, batch_size=DP_EXTRACT_BATCH), uris,
                               os.path.join(workdir, f"features_{arch}"), mesh=mesh,
                               log_fn=lambda m: None)
        out[f"dp extract {arch}"] = launch_counts()
        if sorted(res["saved"]) != sorted(uris) or len(res["shard"]["saved"]) != len(uris) // mesh.world_size:
            raise AssertionError(f"rank {mesh.rank}: the extraction shards are not the videos split by rank")
    nv, npairs = DP_DRIVER
    ap = AnonymizationParams(arch_fa="unet", batch_size=nv, batch_size_vispr=npairs, v_batch_size=2,
                             num_modes=1, save_acc_threshold=-1.0, run_id="dp_adv")
    zero_launch_counts()
    res = train_anonymizer(
        ap, train_items=synthetic_video_items(2 * nv, ap.num_classes, num_frames=64, h=240, w=320, seed=0),
        val_items=synthetic_video_items(2, ap.num_classes, num_frames=64, h=240, w=320, seed=1),
        vispr_source=SyntheticImageSource(n=2 * npairs, seed=0), save_dir=os.path.join(workdir, "dp_adv"),
        max_epochs=1, log_fn=lambda m: None, device=device, mesh=mesh)
    out["dp adversarial"] = launch_counts()
    h = res["history"]
    if not (all(len(v) == 1 for v in h.values()) and np.isfinite([v[0] for v in h.values()]).all()):
        raise AssertionError(f"rank {mesh.rank}: train_anonymizer(mesh=) history out of range: {h}")
    out["dp adversarial history"] = h
    return out


def dp_rank_main(rank: int, world: int, workdir: str) -> int:
    """A rank of phase 16 (``chip_smoke.py --dp-rank R --dp-world W --dp-dir DIR``): joins
    the gloo group through DIR's FileStore on cuda:0, runs the steps in float64 and
    float32, times them, drives the data-parallel kernel paths, and saves it all as
    DIR/rank{R}.pt."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from ted_spad_tpu_torch.parallel import data_parallel_mesh, multihost

    multihost.initialize_distributed(f"file://{os.path.join(workdir, 'store')}", world, rank,
                                     backend="gloo", timeout_s=DP_RANK_TIMEOUT_S)
    device = torch.device(DP_DEVICE)
    mesh = data_parallel_mesh(device)
    path, deadline = os.path.join(workdir, "inputs.pt"), time.perf_counter() + DP_RANK_TIMEOUT_S
    while not os.path.exists(path):  # the parent writes it after its one-process steps
        if time.perf_counter() > deadline:
            raise TimeoutError(f"no {path} after {DP_RANK_TIMEOUT_S}s")
        time.sleep(0.2)
    inputs = torch.load(path, weights_only=False)
    t0 = time.perf_counter()
    out = dp_run(device, inputs, mesh)
    out["launches"] = dp_kernel_paths(device, os.path.join(workdir, f"rank{rank}"), mesh)
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def _dp_worst(got: dict, ref: dict, lr: float) -> tuple[float, str, float]:
    """A step against a reference step: the worst max |got - ref| / max |ref| over its
    losses, gradients and state after the optimizer, and the worst state difference,
    in units of ``lr``, at the entries the rule below sets apart. A gradient at most
    DP_NULL_GRAD of the step's largest (zero in exact arithmetic: a bias ahead of a
    train-mode BatchNorm) is rounding noise on both sides: the tensor is held as a share
    of that largest gradient, and Adam, which moves such an entry by up to about lr
    whatever the noise's size, is held there to 2 lr."""
    import torch

    worst = [(float((got["losses"] - ref["losses"]).abs().max() / ref["losses"].abs().max()), "losses")]
    top = max(float(g.abs().max()) for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        d = float((got["grads"][k] - g).abs().max())
        worst.append((d / max(float(g.abs().max()), DP_NULL_GRAD * top), f"grads {k}"))
    noise_worst = 0.0
    for k, v in ref["state"].items():
        d = (got["state"][k] - v).abs()
        g = ref["grads"].get(k)
        noise = g.abs() <= DP_NULL_GRAD * top if g is not None else torch.zeros_like(d, dtype=torch.bool)
        scale = float(v.abs().max())
        live = float(d[~noise].max()) if bool((~noise).any()) else 0.0
        worst.append((live / scale if scale else (0.0 if live == 0 else float("inf")), f"state {k}"))
        if bool(noise.any()):
            noise_worst = max(noise_worst, float(d[noise].max()) / lr)
    rel, where = max(worst)
    return rel, where, noise_worst


def _dp_f32(got: dict, ref: dict) -> tuple[float, float]:
    """A float32 step's reading against the float64 one: the losses' worst relative
    error and the worst gradient ||d|| / ||g|| (gradients zero in exact arithmetic, at
    most DP_NULL_GRAD of the largest, left out)."""
    loss = float(((got["losses"] - ref["losses"]).abs() / ref["losses"].abs()).max())
    top = max(float(g.norm()) for g in ref["grads"].values())
    grad = max(float((got["grads"][k] - g).norm() / g.norm()) for k, g in ref["grads"].items()
               if float(g.norm()) > DP_NULL_GRAD * top)
    return loss, grad


def dp_phase(device, workdir: str, card: str) -> dict:
    """Phase 16: data parallel on the card. The inputs of four steps (MGFN at the UCF
    preset, the I3Res50 action step, the adversarial fa step under accum_steps 2 and
    the fb/ft step, full model widths, batches cut to DP_*), the one-process card steps
    in float64 and float32, then DP_WORLD gloo ranks on cuda:0 (each its own process,
    killed if the phase fails): every rank's float64 step within DP_RTOL of the
    one-process float64 step, its float32 reading printed beside the one-process
    float32 one; step times and the collectives' share; the kernels' launches on the
    ranks' extraction and adversarial-driver paths. Then a group of one over NCCL runs
    train_anonymizer(mesh=) for one step. Returns {path: launch counts}."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ted_spad_tpu_torch.chip_probes import mgfn_batch
    from ted_spad_tpu_torch.config.params import AnonymizationParams
    from ted_spad_tpu_torch.data.images import SyntheticImageSource
    from ted_spad_tpu_torch.data.videos import ClipDataset, synthetic_video_items
    from ted_spad_tpu_torch.parallel import data_parallel_mesh, multihost
    from ted_spad_tpu_torch.stages.anonymization_training import train_anonymizer

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "dp")
    os.makedirs(root)
    # The ranks start first: they import, reach the card and join the group while this
    # process builds the inputs and runs the one-process steps; then they read the inputs.
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
                               "--dp-world", str(DP_WORLD), "--dp-dir", root],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(DP_WORLD)]
    outs = []
    try:
        params = _dp_params()
        pa, padv = params["action"], params["adversarial"]
        ds = ClipDataset(synthetic_video_items(2 * pa.batch_size, pa.num_classes, num_frames=64, h=240,
                                               w=320, seed=0), pa, views=3, num_workers=8, seed=0)
        try:
            action = next(ds.batches(pa.batch_size, seed=1))
        finally:
            ds.close()
        inputs = {"mgfn": mgfn_batch(params["mgfn"]), "action": (action.clips, action.labels, action.params),
                  "adversarial": _adv_inputs(padv, padv.batch_size, padv.batch_size_vispr, count=1)[0]}
        one = dp_run(device, inputs, None)
        torch.cuda.empty_cache()
        torch.save(inputs, os.path.join(root, "inputs.tmp"))
        os.replace(os.path.join(root, "inputs.tmp"), os.path.join(root, "inputs.pt"))
        for proc in procs:
            outs.append(proc.communicate(timeout=DP_RANK_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            raise AssertionError(f"data-parallel rank {r} failed (exit {proc.returncode}):\n"
                                 + "\n---\n".join(o[-6000:] for o in outs))
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(DP_WORLD)]
    log(f"[dp] {DP_WORLD} gloo ranks on cuda:0, started with this phase, done after "
        f"{time.perf_counter() - t0:.1f}s of wall time (each {', '.join(f'{r['seconds']:.1f}s' for r in ranks)} "
        f"after reading the inputs) | {card}")

    shapes = {"mgfn": f"MGFN UCF preset, {DP_MGFN_BATCH} videos per half",
              "action": f"I3Res50 action 'trip', {DP_ACTION[0]} videos x 3 views x {DP_ACTION[1]} x {DP_ACTION[2]}^2",
              "fa": f"fa step, accum_steps {DP_ACCUM}, {DP_ADV[0]} videos x 3 views x {DP_ADV[2]} x {DP_ADV[3]}^2 + "
                    f"{DP_ADV[1]} VISPR pairs",
              "fbft": f"fb/ft step, {DP_ADV[0]} videos + {DP_ADV[1]} VISPR pairs (rows in the fa step's layout)"}
    lrs = {"mgfn": params["mgfn"].lr, "action": pa.learning_rate, "fa": 1e-3, "fbft": 1e-3}
    for which in DP_STEPS:
        ref, lr = one["float64"][which], lrs[which]
        worst = [_dp_worst(r["float64"][which], ref, lr) for r in ranks]
        f32 = [_dp_f32(r["float32"][which], ref) for r in ranks]
        f32_one = _dp_f32(one["float32"][which], ref)
        (ms1, _), times = one["times"][which], [r["times"][which] for r in ranks]
        log(f"[dp] {which} ({shapes[which]}): sharded float64 step against the one-process float64 step, "
            f"worst max|d|/max|ref| per rank {', '.join(f'{w[0]:.3e} at {w[1]}' for w in worst)} (limit "
            f"{DP_RTOL}; Adam's moves on noise gradients at most {max(w[2] for w in worst):.2e} lr, limit 2); "
            f"float32 readings against it (loss rel, worst gradient ||d||/||g||): sharded "
            f"{', '.join(f'{w[0]:.3e}, {w[1]:.3e}' for w in f32)}; one-process {f32_one[0]:.3e}, "
            f"{f32_one[1]:.3e}; float32 step ms: one process {ms1:.2f}, sharded per rank "
            f"{', '.join(f'{t[0]:.2f} (collectives {100 * t[1]:.1f}%)' for t in times)} | {card}")
        if not all(w[0] <= DP_RTOL and w[2] <= 2.0 for w in worst):
            raise AssertionError(f"the sharded {which} step is not the one-process step: {worst}")

    launches = {}
    for r, res in enumerate(ranks):
        for path, counts in res["launches"].items():
            if path.endswith("history"):
                continue
            launches[f"{path} rank{r}"] = counts
        log(f"[dp] rank {r} kernel launches: {json.dumps({k: v for k, v in res['launches'].items() if not k.endswith('history')})}"
            f"; train_anonymizer(mesh=) history {json.dumps(res['launches']['dp adversarial history'])} | {card}")
    for r in range(DP_WORLD):
        if not (launches[f"dp extract unet++ rank{r}"]["K1 preprocess"] > 0
                and launches[f"dp extract unet rank{r}"]["K2 double_conv"] > 0
                and launches[f"dp adversarial rank{r}"]["K2 double_conv"] > 0):
            raise AssertionError(f"rank {r} did not launch K1 and K2 on its data-parallel paths")
    if ranks[0]["launches"]["dp adversarial history"] != ranks[1]["launches"]["dp adversarial history"]:
        raise AssertionError("the ranks' train_anonymizer histories differ")

    # A group of one over NCCL, the default backend: train_anonymizer(mesh=) for one step.
    t0 = time.perf_counter()
    multihost.initialize_single(backend="nccl", timeout_s=DP_RANK_TIMEOUT_S)
    try:
        mesh = data_parallel_mesh(device)
        nv, npairs = DP_DRIVER
        ap = AnonymizationParams(batch_size=nv, batch_size_vispr=npairs, v_batch_size=2, num_modes=1,
                                 save_acc_threshold=-1.0, run_id="dp_nccl")
        res = train_anonymizer(
            ap, train_items=synthetic_video_items(nv, ap.num_classes, num_frames=64, h=240, w=320, seed=0),
            val_items=synthetic_video_items(2, ap.num_classes, num_frames=64, h=240, w=320, seed=1),
            vispr_source=SyntheticImageSource(n=npairs, seed=0), save_dir=os.path.join(root, "nccl"),
            max_epochs=1, log_fn=lambda m: None, device=device, mesh=mesh)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
        multihost.set_host_group(None)
    if not (backend == "nccl" and np.isfinite(res["history"]["loss_fa"]).all()):
        raise AssertionError(f"the NCCL group of one: backend {backend}, history {res['history']}")
    log(f"[dp] NCCL group of one: train_anonymizer(mesh=) one fa step ({nv} videos + {npairs} VISPR pairs at "
        f"{ap.reso_h}^2, bf16), history {json.dumps(res['history'])}, {time.perf_counter() - t0:.1f}s | {card}")
    log(f"[dp] phase time {time.perf_counter() - t_phase:.1f}s")
    return launches


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    import torch

    if "--dp-rank" in sys.argv:  # a rank of phase 16, started by dp_phase
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        return dp_rank_main(int(args["--dp-rank"]), int(args["--dp-world"]), args["--dp-dir"])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing to check", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import ted_spad_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 1
    from ted_spad_tpu_torch.models import load_fa_model

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")

    k1_registers, k2_registers = phase_build()
    k1 = check_preprocess(device, k1_registers)
    k2 = check_double_conv(device, k2_registers)

    with tempfile.TemporaryDirectory() as workdir:
        launches = {"unet++": serving_path(device, workdir), "unet": unet_path(device, workdir)}
        serving_cli(workdir)
        features = sorted(os.path.join(workdir, "features", f)
                          for f in os.listdir(os.path.join(workdir, "features")) if f.endswith(".npy"))
        launches["anomaly"] = anomaly_stage(device, workdir, features, card)
        if any(launches["anomaly"].values()):
            raise AssertionError(f"the anomaly stage launched a kernel: {launches['anomaly']}")
        options, ten_crop = extraction_options(device, workdir, card)
        launches.update(options)
        fa = load_fa_model(seed=0, device=device)
        fa32 = load_fa_model(seed=0, dtype="float32", device=device)
        k3, launches["yuv"] = yuv_path(device, workdir, fa, fa32, card)
        del fa32
        k4, launches["int8"] = int8_path(device, workdir, fa, card)
        del fa
        launches["training"] = training_phase(device, workdir, card)
        if any(launches["training"].values()):
            raise AssertionError(f"the training path launched a kernel: {launches['training']}")
        launches["privacy"], launches["adversarial"] = privacy_phase(device, workdir, card)
        k2_f32, vis_launches = visualization_phase(device, workdir, card)
        launches.update(vis_launches)
        launches["ft families"] = ft_families_phase(device, workdir, card)
        launches.update(dp_phase(device, workdir, card))
    # Each kernel's launches on its own main path (K1: the default UNet++ path, K2: the
    # plain-UNet path, K3: the YUV path, K4: the int8 path), and on every path driven.
    for k, name, path in ((k1, "K1 preprocess", "unet++"), (k2, "K2 double_conv", "unet"),
                          (k3, "K3 preprocess_yuv", "yuv"), (k4, "K4 int8_conv", "int8")):
        k["launches"] = launches[path][name]
        k["launches_by_path"] = {where: counts[name] for where, counts in launches.items()}
    k1["ten_crop"] = ten_crop
    k2["float32_chunk"] = k2_f32

    log(f"[card] command time {time.perf_counter() - T0:.1f}s")
    log(json.dumps({"kernels": [k1, k2, k3, k4]}))
    log(f"[card] {card}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
