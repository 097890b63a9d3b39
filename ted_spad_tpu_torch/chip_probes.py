"""Measurements on a CUDA card that informed the port's kernels, kept so that the
numbers PERF.md quotes from them can be taken again:

    python -m ted_spad_tpu_torch.chip_probes k1     # kernel K1 alone
    python -m ted_spad_tpu_torch.chip_probes k2     # kernel K2 alone
    python -m ted_spad_tpu_torch.chip_probes k2ab PARENT   # K2's float32 form: PARENT vs this tree
    python -m ted_spad_tpu_torch.chip_probes k2ab DIR DIR...   # K2's float32 form of copies, in turns
    python -m ted_spad_tpu_torch.chip_probes k3     # kernel K3 (YUV420 preprocess) alone
    python -m ted_spad_tpu_torch.chip_probes k3ab DIR...   # K3 of copies of the package, in turns
    python -m ted_spad_tpu_torch.chip_probes k4     # kernel K4 (int8 conv) alone
    python -m ted_spad_tpu_torch.chip_probes k4class   # K4 at the serving 2D 3x3 convs, timed only
    python -m ted_spad_tpu_torch.chip_probes int8ab PARENT   # int8 step: PARENT vs this tree
    python -m ted_spad_tpu_torch.chip_probes fastforms   # the eval fast forms' pieces, timed
    python -m ted_spad_tpu_torch.chip_probes stepab PARENT   # UNet++ serving step: PARENT vs this tree
    python -m ted_spad_tpu_torch.chip_probes trainab   # training steps: train forms vs module forms
    python -m ted_spad_tpu_torch.chip_probes gain   # the UNet's outc gain vs the gates
    python -m ted_spad_tpu_torch.chip_probes mgfn   # where MGFN's card-vs-CPU step error sits
    python -m ted_spad_tpu_torch.chip_probes k5     # kernel K5 (3D max-pool backward) alone
    python -m ted_spad_tpu_torch.chip_probes k6     # kernel K6 (bilinear upsample backward) alone
    python -m ted_spad_tpu_torch.chip_probes k5ab PARENT   # K5: PARENT vs this tree, in turns
    python -m ted_spad_tpu_torch.chip_probes k6ab PARENT   # K6: PARENT vs this tree, in turns
    python -m ted_spad_tpu_torch.chip_probes repeat   # every training step run twice, compared
    python -m ted_spad_tpu_torch.chip_probes repairab   # training steps with and without the cuDNN repair
    python -m ted_spad_tpu_torch.chip_probes validaterepeat [atomic]   # validate_adversarial twice, one seed

``k1``: builds K1 and prints each instantiation's registers and spills, holds it
against its plain version (float32 matmuls, TF32 off) at K1_CASES and over the crops
of K1_CROP_CASES in f32 and bf16, then times it alone at the serving shape, bf16 out (``time_ms``, as chip_smoke.py
times every kernel, and its device-only reading beside), next to its byte bound, the
plain version and both library yardsticks, and at K1_FRAME_SIZES.

``k2``: builds K2 and prints each instantiation's registers and spills (failing if
any spills), holds it against its plain version (float32 convs, TF32 off) at the plain
UNet's nine DoubleConv shapes with two frames and at one ragged shape per bf16 tile
class, in f32 and bf16, and the float32 form alone at K2_F32_RAGGED (one ragged shape
per edge of its tiles), then times the bf16 kernel alone at 256 frames (CUDA events),
with each shape's tile class, and the float32 form at the nine DoubleConvs of one
VIS_CHUNK chunk beside the cuDNN float32 pairs.

``k2ab PARENT``: K2's float32 form of PARENT (another checkout, e.g. ``git archive`` of
the parent commit unpacked under ``build/``) and of this tree in turns, parent / change
/ change / parent, each turn a process of its own under that tree's package and kernel
(``k2turn``): registers, the worst error against the plain version and the event and
device-only times at the nine DoubleConvs of one VIS_CHUNK chunk. ``k2ab DIR DIR ...``:
the same turn for each copy of the package given (e.g. forms of the kernel under
``build/``), once each, in that order.

``k3``: builds K3 and prints each instantiation's registers and spills beside the blocks
per SM its plans count on (failing on a spill or a shortfall), holds it against its plain
version (float32 matmuls, TF32 off) at K3_CASES in f32 and bf16 and checks its refusal
of a chroma-misaligned window, then times it at the serving batch and at K3_FRAME_SIZES
beside its byte bound, the plain version and the per-plane F.interpolate yardstick.

``k3ab DIR [DIR ...]``: K3 of each copy of the package (e.g. the parent commit's
``ted_spad_tpu_torch`` from ``git archive`` and stages of a change, unpacked under
``build/``) in the order given, parent / change / change / parent, each turn a process
of its own: registers, the check at K3_CASES (``DIR:timing`` skips it, for diagnostic
forms), event and device-only times at the serving batch and K3_FRAME_SIZES beside the
byte bound.

``k4``: builds K4, prints its registers, holds it bit for bit against its plain version
(float64 convolutions of the codes, exact, then the epilogue's torch ops) at K4_CASES
with each epilogue form of K4_FORMS, in bf16 and f32, then records the 79 int8 convs of
a serving step (random clips, seeded weights) and times each alone at its shape with its
own epilogue form, beside its bound, with the totals per shape class.

``int8ab PARENT``: the int8 serving step of PARENT (another checkout, e.g. ``git archive``
of the parent commit unpacked under ``build/``) and of this tree in turns, parent /
change / change / parent, each in a process of its own: step time, the bf16 step's, K4's
device time per step from the profiler and the top kernels, and the step outputs on the
first batch compared bit for bit under deterministic cuDNN.

``fastforms``: the eval fast forms (ops/fast_unetpp.py, ops/fast_i3d.py) at the serving
batch, bf16, each piece timed (CUDA events) beside its module form, with the profiler's
top kernels: the UNet++ fa (module; fused with each encoder stem mode; the s2d head),
the I3Res50 stem (module ConvBN; the s2d relayout of a clip batch; the s2d stem) and the
16-clip extraction step (module forms; fast forms, bridged), each checked against the
module form (error over the spread between frames or clips).

``stepab PARENT``: the 16-clip UNet++ serving step (``make_extract_step`` at the default
configuration, seeded models, the first batch of STEP_AB_URIS) of PARENT (e.g. ``git
archive`` of the parent commit unpacked under ``build/``) and of this tree in turns,
parent / change / change / parent, each turn a process of its own (``stepturn``): step
time (CUDA events), device time per step, busy share and top kernels from the profiler,
and the change's features against the parent's (error over the spread between clips).

``trainab``: the training steps at the stages' defaults, bf16 under autocast, with the
train fast forms (ops/fast_unetpp.py's ``fast_unetpp_train_apply``, ops/fast_i3d.py's
``make_fast_ft_train_forward``) and with the module forms (``module_train_forms``) in
TRAINAB_TURNS (train / module / module / train, twice) after one discarded turn
(``train_ab``), each turn its step built anew, two warm-up steps and TRAINAB_STEPS timed
(CUDA events), then one step profiled, and checked to have run its form (``counted``):
the fa pretraining step (UNet++, 32 x 224^2), the action step (I3Res50 with its head, 16
videos x 3 views of 16 x 224^2, FrozenBN) and the adversarial fa and fb/ft steps (8
videos x 3 views + 12 VISPR pairs) under remat "auto", "blocks" and "off". Prints each
turn's steps, peak memory, device time per step and busy share, then per step the
median of each form over its turns beside the spread between its turns.

``gain``: the random-init UNet's sigmoid output sits near 0.5, so the bf16 ft's own
rounding can swamp the differences between clips. For outc gains 1, 4, 8 and 16 it
prints the fa output's spread and both fidelity readings of chip_smoke.py (features
and fa output, bf16 kernel path against the f32 plain path, with their controls).

``k5``: builds K5 (csrc/maxpool3d.cu) and prints its registers and spills (failing on
a spill), holds it bit for bit against its plain version at K5_CASES in float32, bf16
and float64, NCDHW and channels_last_3d, with planted ties and without, then times it at
the adversarial step's stem pool (K5_TIMED) beside its byte bound, the plain version and
torch's own atomic backward. ``k6``: the same for K6 (csrc/upsample_bilinear.cu) at
K6_CASES in float32 and float64, NCHW and channels_last, timed at the UNet's largest
upsample on the fa pretraining batch (K6_TIMED).

``k5ab PARENT`` / ``k6ab PARENT``: K5's / K6's build of PARENT (another checkout, e.g.
``git archive`` of the parent commit unpacked under ``build/``) and of this tree in turns,
parent / change / change / parent, each turn a process of its own under that tree's
package and kernel (``backwardturn``): registers, and the kernel held bit-equal to its
plain version and timed at K5_TIMED and K5_AB (K6_TIMED and K6_AB) beside torch's atomic
backward and the byte bound.

``repeat``: every training step of ``repeat_groups`` at full width (the adversarial fa
and fb/ft steps at AnonymizationParams' defaults; the I3Res50 action step; fa
pretraining with the UNet++ and with the plain UNet; the adversarial steps with
InceptionI3d and MViTv2-S; the plain-UNet fa's adversarial step; the privacy step; the
MGFN step), each run twice from the same saved state, batch and dropout draw and once
with one input value moved by one level (``repeat_case``), under the default settings
and without the stages' deterministic cuDNN scope (``without_cudnn_repair``): whether
the losses are equal, which parameters and buffers are bit-equal after the step, the
first module whose output, or whose output's gradient, differs between the runs
(forward and tensor hooks recording an exact digest of each, ``recorded``), and K5's
and K6's launches. Then the default runs in a process of its own (``repeatdet``) with
CUBLAS_WORKSPACE_CONFIG=:4096:8 and ``torch.use_deterministic_algorithms(True,
warn_only=True)``: every op torch still flags as having no deterministic form.

``repairab``: each of those steps with the deterministic cuDNN scope and without it, in
alternating turns (repaired / unrepaired / unrepaired / repaired) after a discarded one,
TRAINAB_STEPS timed steps a turn (CUDA events): the medians and the repair's cost.

``validaterepeat``: ``validate_adversarial --scale reference`` cut to one adversarial
and one attack epoch, twice from one seed: both cMAPs, every history and the trained
fa compared bit for bit. ``validaterepeat atomic``: the same with the pools and the
upsample on torch's atomic backwards, as the port ran before K5 and K6.

``mgfn``: one MGFN train step (UCF preset, dropout 0, 16 + 16 synthetic videos pooled
as the stage pools them) from the same weights on the card, under cuDNN's default
algorithms, with ``cudnn.deterministic`` and with cuDNN off, and on the CPU, once from
the seeded init and once from weights moved off it (``perturbed_mgfn``); prints the
smallest gap between a video's k-th and (k+1)-th token magnitude, how many videos'
top-k picks differ from the CPU's, each variant's worst gradients against the CPU's
(||d|| / ||g||), and for ``to_tokens.weight`` each side's error against a float64
weight gradient computed from that side's own upstream gradient, which separates the
weight-gradient convolution's rounding from the rounding of everything above it.
"""

from __future__ import annotations

import contextlib
import re
import sys
import time

# The plain UNet's nine DoubleConvs: (block, H = W at 224^2 input, Cin, Cmid, Cout).
UNET_DOUBLECONVS = (
    ("inc", 224, 3, 64, 64), ("down1", 112, 64, 128, 128), ("down2", 56, 128, 256, 256),
    ("down3", 28, 256, 512, 512), ("down4", 14, 512, 512, 512), ("up1", 28, 1024, 512, 256),
    ("up2", 56, 512, 256, 128), ("up3", 112, 256, 128, 64), ("up4", 224, 128, 64, 64),
)
# K2's float32 form on the visualization path: the nine at one chunk of 32 frames of
# 240x320 (stages/visualization.py's defaults).
VIS_CHUNK = (32, 240, 320)


def unet_doubleconv_shapes(h: int, w: int) -> list[tuple]:
    """The nine DoubleConvs of the plain UNet on an (h, w) input: (block, H, W, Cin,
    Cmid, Cout), each block at UNET_DOUBLECONVS' scale of its 224^2 size."""
    return [(name, h * s // 224, w * s // 224, ci, cm, co) for name, s, ci, cm, co in UNET_DOUBLECONVS]


# K2 beside the nine is also timed at the UNet++ decoder's 112^2 / 56^2 cluster (name,
# H = W, Cin, Cmid, Cout; scripts/microbench_fa.py:240-243).
UNETPP_CLUSTER = (
    ("x_2_2", 112, 128, 64, 64), ("x_1_2", 112, 192, 64, 64), ("x_0_2", 112, 320, 64, 64),
    ("x_0_1", 56, 384, 128, 128),
)

# One ragged shape per bf16 tile class (N, H, W, Cin, Cmid, Cout): H and W are not
# multiples of the class's tile.
K2_CLASS_RAGGED = (
    ("ragged 16x16", (2, 20, 20, 64, 64, 64)), ("ragged 16x28", (2, 20, 30, 96, 128, 64)),
    ("ragged 14x14", (2, 20, 30, 128, 256, 128)), ("ragged 7x14", (2, 12, 20, 256, 512, 256)),
)

# The float32 form's tiles are flat runs of BM pixels over frames and BN output
# channels, K = 9 * Cin in stages of 16: one shape per edge (N, H, W, Cin, Cmid, Cout).
K2_F32_RAGGED = (
    ("f32 M across frames", (3, 7, 9, 64, 96, 64)),  # 189 pixels: tiles span frames
    ("f32 N ragged", (2, 12, 20, 64, 200, 40)),      # 200 of 2 x 128, 40 of 64
    ("f32 K ragged", (2, 12, 20, 20, 36, 130)),      # Cin 20: a chunk of 4 of 16
    ("f32 Cin 3", (2, 30, 40, 3, 64, 64)),           # inc: 27 k rows, 4-byte copies
    ("f32 odd channels", (3, 5, 7, 13, 70, 37)),     # 4-byte x, weights and stores
)
K2_F32_TOL = 1e-4  # of max|plain|: float32 summation order


# K1 against its plain version: (name, clip batch shape, out_h, out_w, byte offset of the
# batch in its buffer). The serving batch; a ragged one (f32 rows of 480 B, 5 runs);
# ShanghaiTech's native frame (pitch 2,568 B, window at 258 B: unaligned, KY 4, KX 7);
# 1080p (KY 8, KX 14); the serving batch at an odd base address; a 10x downscale past
# every compile-time instantiation (the runtime-taps kernel).
K1_CASES = (
    ("serving", (16, 16, 240, 320, 3), 224, 224, 0),
    ("ragged", (2, 3, 61, 83, 3), 56, 40, 0),
    ("480x856", (1, 4, 480, 856, 3), 224, 224, 0),
    ("1080x1920", (1, 2, 1080, 1920, 3), 224, 224, 0),
    ("serving at base + 1 B", (16, 16, 240, 320, 3), 224, 224, 1),
    ("runtime taps", (1, 2, 200, 300, 3), 16, 16, 0),
)
# K1 over crops against its plain version: (name, clip batch shape, out_h, out_w, byte
# offset, crops as (kind, argument)): torchvision's ten crops at the serving frame, at
# ShanghaiTech's and at a ragged frame (odd offsets, a short last run mirrored), the
# five crops at an odd base address, and no_ar_distortion's square window.
K1_CROP_CASES = (
    ("ten-crop serving", (16, 16, 240, 320, 3), 224, 224, 0, ("multi", 10)),
    ("ten-crop 480x856", (1, 4, 480, 856, 3), 224, 224, 0, ("multi", 10)),
    ("ten-crop ragged", (2, 3, 61, 83, 3), 56, 44, 0, ("multi", 10)),
    ("five-crop at base + 1 B", (2, 16, 240, 320, 3), 224, 224, 1, ("multi", 5)),
    ("square window", (16, 16, 240, 320, 3), 224, 224, 0, ("square", None)),
)
# K1 timed beside the serving batch: ShanghaiTech's native frames and 1080p, bf16 out.
K1_FRAME_SIZES = ((16, 16, 480, 856, 3), (4, 16, 1080, 1920, 3))
K1_F32_TOL = 1e-5  # float32 rounding on [0, 1] images
K1_BF16_TOL = 2.0 ** -7  # one bf16 ulp at 1.0
K1_INTERPOLATE_TOL = 5e-5  # F.interpolate computes the filter weights in its own arithmetic
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores
F32_PEAK_PER_MHZ = 132 * 128 * 2 * 1e6  # its 132 SMs' float32 FMAs, FLOP per cycle, per MHz


def k1_register_report(nvcc_out: str, log=print) -> dict[str, dict[str, int]]:
    """Each K1 instantiation's registers and spill bytes from nvcc's ptxas report,
    logged and keyed "bf16 K1<KY, SPAN>" (``k1_plan(...).kernel`` with the output type),
    "bf16 K1<KY, SPAN> mirror" for the instantiation that stores mirrored crops; raises if
    one needs more registers than the blocks per SM that the plan counts on for it
    (``K1_TAPS``) allow."""
    from ted_spad_tpu_torch.ops import preprocess as pp
    from ted_spad_tpu_torch.utils import cuda_build

    blocks = {f"K1<{k}, {s}>": b for k, s, b in pp.K1_TAPS} | {"K1<runtime>": pp.K1_BLOCKS_PER_SM}
    report = {}
    for name, r in cuda_build.ptxas_report(nvcc_out).items():
        m = re.search(r"preprocess_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb([01])E", name)
        if not m:
            continue
        kernel = "K1<runtime>" if m.group(2) == "0" else f"K1<{m.group(2)}, {m.group(3)}>"
        label = (f"{'f32' if m.group(1) == 'f' else 'bf16'} {kernel}"
                 + (" mirror" if m.group(4) == "1" else ""))
        report[label] = r
        log(f"[K1 build] {label}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} B, spill loads {r['spill_loads']} B")
        n = blocks[kernel]  # 256 threads a block, registers taken in eights
        if n * 256 * (-(-r["registers"] // 8) * 8) > pp.REGISTERS_PER_SM:
            raise AssertionError(f"K1 {label} needs {r['registers']} registers: the {n} blocks "
                                 f"per SM its plan counts on do not fit")
    return report


def k1_clips(device, shape, offset: int = 0, seed: int = 0):
    """Seeded uint8 clips on the card; ``offset`` > 0 places them that many bytes into
    a buffer, so that their base address is not aligned."""
    import numpy as np
    import torch

    data = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8))
    buf = torch.empty(data.numel() + offset, dtype=torch.uint8, device=device)
    clips = buf[offset:].view(shape)
    clips.copy_(data)
    return clips


def k1_check(device, log=print) -> float:
    """K1 against fused_preprocess_reference (TF32 off) at every K1_CASES entry, f32
    and bf16 out; raises beyond the tolerances. Returns the worst max abs error."""
    import torch

    from ted_spad_tpu_torch.ops import preprocess as pp
    from ted_spad_tpu_torch.utils.device import tf32_off

    worst = 0.0
    for i, (name, shape, oh, ow, offset) in enumerate(K1_CASES):
        clips = k1_clips(device, shape, offset, seed=i)
        plan = pp.k1_plan(*shape[2:4], oh, ow, 0.8)
        for dtype, tol in ((torch.float32, K1_F32_TOL), (torch.bfloat16, K1_BF16_TOL)):
            got = pp.fused_preprocess(clips, out_h=oh, out_w=ow, out_dtype=dtype)
            with tf32_off():
                ref = pp.fused_preprocess_reference(clips, out_h=oh, out_w=ow, out_dtype=dtype)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            log(f"[K1] {name} {tuple(shape)} -> {oh}x{ow} {str(dtype)[6:]} ({plan.kernel}, "
                f"{plan.band_rows} rows, {plan.smem_bytes} B, {plan.blocks_per_sm} blocks per "
                f"SM): max|kernel - plain| = {err:.3e} (tolerance {tol:.3e})")
            if not (got.shape == ref.shape and err <= tol):
                raise AssertionError(f"K1 disagrees with its plain version at {name}: {err} > {tol}")
            worst = max(worst, err)
    return worst


def k1_crops(shape, kind: str, arg) -> list:
    """The crops of a K1_CROP_CASES entry (cropping factor 0.8)."""
    from ted_spad_tpu_torch.ops import preprocess as pp

    h, w = shape[2:4]
    if kind == "multi":
        return pp.multi_crops(h, w, 0.8, arg)
    return [pp.center_crop(h, w, 0.8, square=True)]


def k1_crop_check(device, log=print) -> float:
    """K1 over crops (one launch for all crops of a batch) against
    fused_preprocess_reference with the same crops (TF32 off), f32 within K1_F32_TOL and
    bf16 within K1_BF16_TOL of max|plain|, at every K1_CROP_CASES entry. Returns the
    worst max abs error."""
    import torch

    from ted_spad_tpu_torch.ops import preprocess as pp
    from ted_spad_tpu_torch.utils.device import tf32_off

    worst = 0.0
    for i, (name, shape, oh, ow, offset, (kind, arg)) in enumerate(K1_CROP_CASES):
        clips = k1_clips(device, shape, offset, seed=20 + i)
        crops = k1_crops(shape, kind, arg)
        plan = pp.k1_plan(*shape[2:4], oh, ow, window=crops[0].window)
        for dtype, tol in ((torch.float32, K1_F32_TOL), (torch.bfloat16, K1_BF16_TOL)):
            launches = pp.fused_preprocess.launches
            got = pp.fused_preprocess(clips, out_h=oh, out_w=ow, crops=crops, out_dtype=dtype)
            if pp.fused_preprocess.launches != launches + 1:
                raise AssertionError("K1 took more than one launch for the crops of a batch")
            with tf32_off():
                ref = pp.fused_preprocess_reference(clips, out_h=oh, out_w=ow, crops=crops,
                                                    out_dtype=dtype)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            log(f"[K1 crops] {name} {tuple(shape)} x{len(crops)} -> {oh}x{ow} {str(dtype)[6:]} "
                f"({plan.kernel}, {plan.band_rows} rows): max|kernel - plain| = {err:.3e}, "
                f"{err / scale:.3e} of max|plain| (tolerance {tol:.3e})")
            if not (got.shape == ref.shape and err <= tol * scale):
                raise AssertionError(f"K1 disagrees with its plain version at {name}: {err}")
            worst = max(worst, err)
    return worst


def k1_bound(clips_shape, out_h: int, out_w: int, out_bytes: int):
    """(bytes, f32 FLOP, (window rows, cols)) that the preprocess of one clip batch
    needs: ``k1_crops_bound`` of the 0.8 centre crop, and the crop window's size."""
    import numpy as np

    from ted_spad_tpu_torch.ops import preprocess as pp

    h, w = clips_shape[2:4]
    ry, rx = pp.preprocess_matrices(h, w, out_h, out_w, 0.8)
    bytes_moved, flops = k1_crops_bound(clips_shape, [pp.center_crop(h, w, 0.8)], out_h, out_w,
                                        out_bytes)
    window = (np.flatnonzero(ry.any(axis=0)).size, np.flatnonzero(rx.any(axis=0)).size)
    return bytes_moved, flops, window


def k1_crops_bound(clips_shape, crops, out_h: int, out_w: int, out_bytes: int):
    """(bytes, f32 FLOP) that K1 over ``crops`` of one clip batch needs: each input byte
    some crop's R_y and R_x use read once (the union of the windows), each crop's
    output written once, and one multiply-add per nonzero tap of each crop's two
    matrices."""
    import numpy as np

    from ted_spad_tpu_torch.ops import preprocess as pp

    b, t, h, w, c = clips_shape
    used = np.zeros((h, w), bool)
    flops = 0
    for crop in crops:
        ry, rx = pp.window_matrices(h, w, out_h, out_w, crop.window)
        rows, cols = ry.any(axis=0), rx.any(axis=0)
        used |= rows[:, None] & cols[None, :]
        flops += c * 2 * (np.count_nonzero(ry) * int(cols.sum()) + np.count_nonzero(rx) * out_h)
    n = b * t
    return int(n * (int(used.sum()) * c + len(crops) * out_h * out_w * c * out_bytes)), int(n * flops)


def time_ms(fn, reps: int = 20, inner: int = 5, queued: bool = False) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls, in ms,
    from CUDA events. ``queued``: each window first waits on the card behind a ~1 ms
    device sleep, so the host has queued the calls before the first one starts and
    the reading is the card's time alone, without the host's gaps between launches."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def sm_clock_under_load(fn, seconds: float = 1.5) -> dict:
    """The SM clock (MHz) and board power (W) that ``nvidia-smi`` reads every 100 ms
    while ``fn`` runs back to back for ``seconds``: the medians of the samples after the
    first three (which may precede the load), or {} where nvidia-smi is missing. With
    the clock, a rate reads against the peak the card had at that moment."""
    import statistics
    import subprocess

    import torch

    try:
        proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                 "--format=csv,noheader,nounits", "-lms", "100"],
                                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return {}
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    samples = []
    for line in out.splitlines():
        try:
            samples.append(tuple(float(v) for v in line.split(",")))
        except ValueError:
            continue  # "[N/A]" and partial lines
    samples = [r for r in samples[3:] or samples if len(r) == 2]
    if not samples:
        return {}
    return {"sm_mhz": statistics.median(r[0] for r in samples),
            "power_w": statistics.median(r[1] for r in samples), "samples": len(samples)}


def k1_timing(device, log=print) -> dict:
    """K1 alone at the serving shape, bf16 out, beside its bound, its plain version and
    the two library yardsticks (two dense cuBLAS f32 matmuls; F.interpolate, antialiased,
    on the crop, then a bf16 cast: ops/augment.py:center_crop_resize, held against the
    plain version first). Returns the K1 entry of the kernel table, launches aside."""
    import torch

    from ted_spad_tpu_torch.ops import preprocess as pp
    from ted_spad_tpu_torch.ops.augment import center_crop_resize
    from ted_spad_tpu_torch.utils.device import tf32_off

    shape = K1_CASES[0][1]
    b, t, h, w, c = shape
    clips = k1_clips(device, shape, seed=99)
    with tf32_off():
        ref = pp.fused_preprocess_reference(clips, out_dtype=torch.float32)
    interp_err = float((center_crop_resize(clips, 0.8, 224, 224) - ref).abs().max())
    log(f"[K1] center_crop_resize (F.interpolate, antialias) vs plain at {shape}: max abs "
        f"error {interp_err:.3e} (tolerance {K1_INTERPOLATE_TOL:.0e})")
    if not interp_err <= K1_INTERPOLATE_TOL:
        raise AssertionError(f"the interpolate yardstick does not compute K1's function: {interp_err}")
    del ref
    ms = time_ms(lambda: pp.fused_preprocess(clips))
    device_ms = time_ms(lambda: pp.fused_preprocess(clips), queued=True)
    ry, rx = pp.preprocess_matrices(h, w, 224, 224, 0.8)
    ry_t, rxt = torch.from_numpy(ry).to(device), torch.from_numpy(rx).to(device).T
    planes = clips.reshape(b * t, h, w, c).permute(0, 3, 1, 2).float()
    with tf32_off():
        plain_ms = time_ms(lambda: pp.fused_preprocess_reference(clips))
        library_ms = time_ms(lambda: torch.matmul(torch.matmul(ry_t, planes), rxt))
    del planes
    interp_ms = time_ms(lambda: center_crop_resize(clips, 0.8, 224, 224).to(torch.bfloat16))
    bytes_moved, flops, (rows, cols) = k1_bound(shape, 224, 224, out_bytes=2)
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / F32_FLOPS * 1e3
    bound_ms = max(bound_bytes, bound_ops)
    plan = pp.k1_plan(h, w, 224, 224, 0.8)
    log(f"[K1] serving shape {shape} bf16 ({plan.kernel}, {plan.band_rows} rows, "
        f"{plan.smem_bytes} B): kernel {ms:.4f} ms (device only {device_ms:.4f}) = "
        f"{bytes_moved / ms * 1e-6:.1f} GB/s of the {HBM_BYTES_PER_S * 1e-9:.0f} GB/s rate, "
        f"{ms / bound_ms:.2f}x the bound {bound_ms:.4f} ms ({bytes_moved} B: a {rows}x{cols} "
        f"crop window read, 224x224 written; {flops} f32 FLOP = {bound_ops:.4f} ms); plain "
        f"{plain_ms:.4f} ms, two cuBLAS matmuls {library_ms:.4f} ms, F.interpolate + bf16 cast "
        f"{interp_ms:.4f} ms")
    return {
        "name": "K1 preprocess", "route": "cuda",
        "source": "ted_spad_tpu_torch/csrc/preprocess.cu",
        "replaces": "ted_spad_tpu/ops/pallas_preprocess.py:62",
        "ms": ms, "device_only_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": library_ms, "library_interpolate_ms": interp_ms,
        "gbytes_per_s": bytes_moved / ms * 1e-6, "kernel": plan.kernel,
    }


def k1(device) -> None:
    from ted_spad_tpu_torch.ops import preprocess as pp
    from ted_spad_tpu_torch.utils import cuda_build

    seconds, nvcc_out = cuda_build.build("preprocess")
    registers = k1_register_report(nvcc_out)
    print(f"build {seconds:.2f}s", flush=True)
    print(f"worst max abs error {k1_check(device):.3e}", flush=True)
    print(f"worst max abs error over crops {k1_crop_check(device):.3e}", flush=True)
    k1_timing(device)
    for shape in K1_FRAME_SIZES:
        clips = k1_clips(device, shape, seed=98)
        bytes_moved = k1_bound(shape, 224, 224, out_bytes=2)[0]
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        plan = pp.k1_plan(*shape[2:4], 224, 224)
        ms = time_ms(lambda: pp.fused_preprocess(clips))
        device_ms = time_ms(lambda: pp.fused_preprocess(clips), queued=True)
        regs = registers[f"bf16 {plan.kernel}"]["registers"]
        print(f"[K1] {shape} -> 224x224 bf16 ({plan.kernel}, {regs} registers, {plan.band_rows} "
              f"rows, {plan.smem_bytes} B, {plan.blocks_per_sm} blocks per SM): kernel "
              f"{ms:.4f} ms (device only {device_ms:.4f}) = "
              f"{bytes_moved / ms * 1e-6:.1f} GB/s, {ms / bound_ms:.2f}x the byte bound "
              f"{bound_ms:.4f} ms", flush=True)
        del clips


def k2_register_report(nvcc_out: str, log=print, strict: bool = True) -> dict[str, dict[str, int]]:
    """Each K2 instantiation's registers and spill bytes from nvcc's ptxas report,
    logged and keyed "bf16 Cls<...>" as ``k2_tile_plan(...).kernel`` names it, or
    "f32 BMxBN" as ``k2_f32_plan(...).passes[i].tile`` does; raises if one spills
    (``strict``; an older tree timed by k2ab may name its kernels otherwise)."""
    from ted_spad_tpu_torch.utils import cuda_build

    report = {}
    for name, r in cuda_build.ptxas_report(nvcc_out).items():
        if "double_conv_bf16" in name:
            args = re.findall(r"Li(\d+)E", re.search(r"ClsI(.*?)EE", name).group(1) + "E")
            label = f"bf16 Cls<{', '.join(args)}>"
        elif m := re.search(r"TileILi(\d+)ELi(\d+)E", name):
            label = f"f32 {m.group(1)}x{m.group(2)}"
        else:  # a tree before the float32 redesign: one fused kernel
            label = "f32 double_conv"
        report[label] = r
        log(f"[K2 build] {label}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} B, spill loads {r['spill_loads']} B")
    spills = {k: r for k, r in report.items() if r["spill_stores"] or r["spill_loads"]}
    if strict and spills:
        raise AssertionError(f"K2 instantiations spill registers: {spills}")
    return report


def double_conv_operands(device, shape, dtype, seed: int = 0, b1=None):
    """Seeded K2 inputs made on the card at the UNet's scales, for ``shape`` (N, H, W,
    Cin, Cmid, Cout): x ~ N(0, 1) as after a BN, He-scaled weights, small biases (or
    b1 = the given constant)."""
    import torch

    n, h, w, cin, cmid, cout = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*size):
        return torch.randn(*size, generator=g, device=device)

    x = randn(n, h, w, cin)
    w1 = randn(3, 3, cin, cmid) * (2.0 / (9 * cin)) ** 0.5
    w2 = randn(3, 3, cmid, cout) * (2.0 / (9 * cmid)) ** 0.5
    b1 = randn(cmid) * 0.1 if b1 is None else torch.full((cmid,), b1, device=device)
    b2 = randn(cout) * 0.1
    return x.to(dtype), w1.to(dtype), b1, w2.to(dtype), b2


def k2_f32_error(device, shape, seed: int = 0) -> float:
    """max|K2 - plain| / max|plain| of the float32 form at ``shape`` (N, H, W, Cin,
    Cmid, Cout), the plain version with TF32 off."""
    import torch

    from ted_spad_tpu_torch.ops import doubleconv as dc
    from ted_spad_tpu_torch.utils.device import tf32_off

    args = double_conv_operands(device, shape, torch.float32, seed=seed)
    got = dc.fused_double_conv(*args)
    with tf32_off():
        ref = dc.double_conv_reference(*args)
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / scale if scale > 0 else float("inf")


def k2_f32_chunk_times(device) -> list[dict]:
    """K2's float32 form at the nine DoubleConvs of one VIS_CHUNK chunk, a row each: the
    error against the plain version, event and device-only ms (``time_ms``), the plain
    version's ms and the cuDNN float32 conv + bias + ReLU pair's (both TF32 off), the
    FLOP and the bound: 2*9*(Cin*Cmid + Cmid*Cout) FLOP per pixel at the float32 FMA
    peak, or x, the output, the weights and biases moved once at the memory rate."""
    import torch
    import torch.nn.functional as F

    from ted_spad_tpu_torch.ops import doubleconv as dc
    from ted_spad_tpu_torch.utils.device import tf32_off

    n, rows = VIS_CHUNK[0], []
    for i, (name, h, w, ci, cm, co) in enumerate(unet_doubleconv_shapes(*VIS_CHUNK[1:])):
        shape = (n, h, w, ci, cm, co)
        flops = 2 * n * h * w * 9 * (ci * cm + cm * co)
        by_ops = flops / F32_FLOPS * 1e3
        by_bytes = 4 * (n * h * w * (ci + co) + 9 * (ci * cm + cm * co) + cm + co) / HBM_BYTES_PER_S * 1e3
        row = {"block": name, "shape": [h, w, ci, cm, co], "flops": flops, "bound_ms": max(by_ops, by_bytes),
               "bound_by": "operations" if by_ops >= by_bytes else "bytes",
               "max_rel_err": k2_f32_error(device, shape, seed=50 + i)}
        x, w1, b1, w2, b2 = double_conv_operands(device, shape, torch.float32, seed=50 + i)
        row["ms"] = time_ms(lambda: dc.fused_double_conv(x, w1, b1, w2, b2), reps=3, inner=1)
        row["device_only_ms"] = time_ms(lambda: dc.fused_double_conv(x, w1, b1, w2, b2), reps=3,
                                        inner=1, queued=True)
        xc = x.permute(0, 3, 1, 2)
        w1c, w2c = (t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) for t in (w1, w2))
        with tf32_off():
            row["plain_ms"] = time_ms(lambda: dc.double_conv_reference(x, w1, b1, w2, b2), reps=3, inner=1)
            row["library_ms"] = time_ms(lambda: F.relu(F.conv2d(F.relu(F.conv2d(
                xc, w1c, b1, padding=1)), w2c, b2, padding=1)), reps=3, inner=1)
        rows.append(row)
        del x, w1, w2, xc, w1c, w2c
    return rows


def k2(device) -> None:
    import torch

    from ted_spad_tpu_torch.ops import doubleconv as dc
    from ted_spad_tpu_torch.utils import cuda_build
    from ted_spad_tpu_torch.utils.device import tf32_off

    seconds, nvcc_out = cuda_build.build("doubleconv")
    k2_register_report(nvcc_out)
    print(f"build {seconds:.2f}s", flush=True)
    cases = [(name, (2, s, s, cin, cmid, cout)) for name, s, cin, cmid, cout in UNET_DOUBLECONVS]
    worst = 0.0
    for name, shape in cases + list(K2_CLASS_RAGGED):
        for dtype, tol in ((torch.float32, K2_F32_TOL), (torch.bfloat16, 2.0 ** -6)):
            args = double_conv_operands(device, shape, dtype)
            got = dc.fused_double_conv(*args)
            with tf32_off():
                ref = dc.double_conv_reference(*args)
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            worst = max(worst, err / scale / tol)
            print(f"{name} {shape} {str(dtype)[6:]}: max|kernel - plain| {err:.3e} = "
                  f"{err / scale:.3e} of max|plain| {scale:.3f} (tolerance {tol:.3e})", flush=True)
    for name, shape in K2_F32_RAGGED:
        err = k2_f32_error(device, shape)
        worst = max(worst, err / K2_F32_TOL)
        print(f"{name} {shape} float32: max|kernel - plain| {err:.3e} of max|plain| "
              f"(tolerance {K2_F32_TOL:.0e})", flush=True)
    print(f"worst error / tolerance {worst:.3f}: {'exact' if worst <= 1 else 'NOT EXACT'}")
    total = 0.0
    for name, s, cin, cmid, cout in UNET_DOUBLECONVS:
        args = double_conv_operands(device, (256, s, s, cin, cmid, cout), torch.bfloat16)
        dc.fused_double_conv(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            dc.fused_double_conv(*args)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 3
        total += ms
        flops = 2 * 256 * s * s * 9 * (cin * cmid + cmid * cout)
        plan = dc.k2_tile_plan(s, s, cin, cmid, cout)
        print(f"{name} x256 bf16 ({plan.kernel}, {plan.smem_bytes} B): kernel {ms:.3f} ms = "
              f"{flops / ms * 1e-9:.1f} TFLOP/s", flush=True)
    print(f"the nine x256 bf16: kernel {total:.3f} ms", flush=True)
    rows = k2_f32_chunk_times(device)
    for r in rows:
        print(f"f32 {r['block']} {r['shape']} x{VIS_CHUNK[0]}: kernel {r['ms']:.3f} ms "
              f"({r['device_only_ms']:.3f} device-only, {r['flops'] / r['device_only_ms'] * 1e-9:.1f} "
              f"TFLOP/s), cuDNN f32 pair {r['library_ms']:.3f} ms, error {r['max_rel_err']:.2e}",
              flush=True)
    *_, (name, h, w, ci, cm, co) = unet_doubleconv_shapes(*VIS_CHUNK[1:])
    args = double_conv_operands(device, (VIS_CHUNK[0], h, w, ci, cm, co), torch.float32)
    clock = sm_clock_under_load(lambda: dc.fused_double_conv(*args))
    if clock:
        print(f"f32 {name} under load: SM clock {clock['sm_mhz']:.0f} MHz, {clock['power_w']:.1f} W "
              f"({clock['samples']} samples): the FMA peak at that clock "
              f"{F32_PEAK_PER_MHZ * clock['sm_mhz'] / 1e12:.1f} TFLOP/s", flush=True)
    del args
    total = {k: sum(r[k] for r in rows) for k in ("ms", "device_only_ms", "library_ms", "flops")}
    print(f"the nine f32 at one {VIS_CHUNK} chunk: kernel {total['ms']:.3f} ms "
          f"({total['device_only_ms']:.3f} device-only, {total['flops'] / total['device_only_ms'] * 1e-9:.1f} "
          f"TFLOP/s), cuDNN f32 pairs {total['library_ms']:.3f} ms", flush=True)
    if worst > 1:
        raise AssertionError(f"K2 disagrees with its plain version: worst error / tolerance {worst:.3f}")


def gain(device) -> None:
    import torch

    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
    from ted_spad_tpu_torch.ops.preprocess import fused_preprocess_reference
    from ted_spad_tpu_torch.stages.feature_extraction import iter_clip_batches, make_extract_step
    from ted_spad_tpu_torch.utils.device import tf32_off

    p = FeatureExtractionParams(batch_size=16, arch_fa="unet")
    uris = [f"synthetic://n=320,h=240,w=320,seed={100 + i}" for i in range(2)]
    batch = torch.from_numpy(next(iter_clip_batches(uris, p, 16, num_workers=8))[0]).to(device)
    b, t = batch.shape[:2]
    img = fused_preprocess_reference(batch, out_dtype=torch.float32)
    frames = img.reshape((b * t,) + img.shape[2:]).permute(0, 3, 1, 2)
    ft = load_ft_model(seed=0, device=device)
    ft32 = load_ft_model(seed=0, dtype="float32", device=device)

    def spread_error(x, ref):  # ||x - ref|| / ||ref - mean over the batch||
        return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref - ref.mean(0)))

    for g in (1.0, 4.0, 8.0, 16.0):
        fa = load_fa_model("unet", seed=0, device=device)
        fa32 = load_fa_model("unet", seed=0, dtype="float32", device=device)
        with torch.no_grad():
            fa.outc.weight.mul_(g)
            fa32.outc.weight.mul_(g)
        step = make_extract_step(ft, p, fa, device=device)
        ref_step = make_extract_step(ft32, p.replace(compute_dtype="float32"), fa32,
                                     use_kernel=False, device=device)
        got, ref = step(batch).double(), ref_step(batch).double()
        swapped = step(batch.flip(-1).contiguous()).double()
        print(f"gain {g}: features error / spread {spread_error(got, ref):.4f}, controls "
              f"R/B {spread_error(swapped, ref):.4f}, previous clip "
              f"{spread_error(got.roll(1, 0), ref):.4f}", flush=True)
        with torch.inference_mode(), tf32_off():
            r = fa32(frames, use_kernel=False).double()
            o, s = fa(frames).double(), fa(frames.flip(1)).double()
        print(f"gain {g}: fa output mean {float(r.mean()):.4f} std {float(r.std()):.4f} "
              f"saturated {float(((r < 0.01) | (r > 0.99)).double().mean()):.4f}, error / spread "
              f"{spread_error(o, r):.4f}, controls R/B {spread_error(s, r):.4f}, previous "
              f"clip {spread_error(o.roll(t, 0), r):.4f}", flush=True)
        del fa, fa32, step, ref_step
        torch.cuda.empty_cache()


def mgfn_batch(p, seed: int = 0):
    """(nfeat, nlabel, afeat, alabel): ``p.batch_size`` normal and abnormal videos of
    40-240 clips of ``p.feature_size``-d features (the abnormal ones with a span of 4
    clips scaled by 6), pooled to ``p.seg_length`` segments with the magnitude channel."""
    import numpy as np

    from ted_spad_tpu_torch.ops.temporal import segment_train_features

    rng = np.random.default_rng(seed)
    halves = []
    for abnormal in (False, True):
        videos = []
        for _ in range(p.batch_size):
            t = int(rng.integers(40, 241))
            x = rng.normal(0, 1, (t, p.feature_size)).astype(np.float32)
            if abnormal:
                s = int(rng.integers(0, t - 4))
                x[s:s + 4] *= 6.0
            videos.append(segment_train_features(x, p.seg_length))
        halves += [np.stack(videos), np.full(p.batch_size, float(abnormal), np.float32)]
    return tuple(halves)


def perturbed_mgfn(p, device, seed: int = 0, dtype=None):
    """The MGFN of ``p`` (its seeded init) with every weight and BN statistic moved off
    its init from a numpy seed, as the CPU parity tests move theirs (x * U(0.8, 1.2) +
    0.05 N(0, 1); variances U(0.5, 1.5)), on ``device`` in ``dtype`` (float32 unless
    given; float64 for a reference step), with gradients on. At the
    init (LayerNorm scale 1, bias 0) every token leaves ``to_logits_norm`` with the
    same magnitude, sqrt(dims[-1]), so the top-k selection picks on rounding noise and
    the gradient through the magnitudes is zero up to rounding; moved weights make
    both well-conditioned, so a card-vs-CPU comparison reads rounding."""
    import numpy as np
    import torch

    from ted_spad_tpu_torch.models import load_mgfn_model
    from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables, state_dict_to_flax

    model = load_mgfn_model(p, device="cpu")
    rng = np.random.default_rng(seed)

    def move(tree, name=""):
        if isinstance(tree, dict):
            return {k: move(v, k) for k, v in tree.items()}
        if name == "var":
            return rng.uniform(0.5, 1.5, tree.shape).astype(np.float32)
        return (tree * rng.uniform(0.8, 1.2, tree.shape)
                + 0.05 * rng.standard_normal(tree.shape)).astype(np.float32)

    load_jax_variables(model, move(state_dict_to_flax(model)))
    return model.to(device, dtype or torch.float32).requires_grad_(True)


def mgfn_step(model, p, batch, device):
    """One ``make_train_step`` call: (loss, gradients and BN statistics as float64 CPU
    tensors by name, the top-k picks per video (sorted), the smallest relative gap
    between each video's k-th and (k+1)-th token magnitude, the upstream gradient of
    ``to_tokens``' output)."""
    import torch

    from ted_spad_tpu_torch.stages.anomaly_detection import make_optimizer, make_train_step

    seen = {}

    def keep_tokens(mod, inp, out) -> None:
        seen["tokens"] = out.detach()

    def keep_upstream(mod, inp, out) -> None:
        out.register_hook(lambda g: seen.setdefault("dy", g))

    hooks = [model.to_logits_norm.register_forward_hook(keep_tokens),
             model.to_tokens.register_forward_hook(keep_upstream)]
    loss = make_train_step(model, make_optimizer(model, p), p, device=device)(*batch)
    for h in hooks:
        h.remove()
    grads = {n: q.grad.double().cpu() for n, q in model.named_parameters()}
    stats = {n: t.double().cpu() for n, t in model.named_buffers() if "running" in n}
    mag = torch.linalg.vector_norm(seen["tokens"].double(), dim=2).cpu()
    top = torch.topk(mag, p.k + 1, dim=1)
    margin = (top.values[:, p.k - 1] - top.values[:, p.k]) / top.values[:, p.k - 1]
    picks = top.indices[:, :p.k].sort(dim=1).values
    return float(loss), grads, stats, picks, float(margin.min()), seen["dy"].double().cpu()


def mgfn(device) -> None:
    import torch

    from ted_spad_tpu_torch.config.params import MGFNParams

    p = MGFNParams.for_dataset("UCF", dropout_rate=0.0)
    batch = mgfn_batch(p)

    def rel(a, b) -> float:
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    video = torch.cat([torch.as_tensor(batch[0]), torch.as_tensor(batch[2])])
    x = video.reshape(-1, *video.shape[2:])[..., :p.feature_size].transpose(1, 2).double()
    w_shape = (p.dims[0], p.feature_size, 3)

    def w_error(grads, dy) -> float:  # against float64 from the same upstream gradient
        exact = torch.nn.grad.conv1d_weight(x, w_shape, dy, padding=1)
        return rel(grads["to_tokens.weight"], exact)

    for weights, seed in (("seeded init", None), ("moved off the init", 0)):
        def model_on(dev):
            if seed is None:
                from ted_spad_tpu_torch.models import load_mgfn_model

                return load_mgfn_model(p, device=dev).requires_grad_(True)
            return perturbed_mgfn(p, dev, seed)

        cpu_loss, cpu_grads, _, cpu_picks, cpu_margin, cpu_dy = mgfn_step(
            model_on("cpu"), p, batch, "cpu")
        print(f"[mgfn] {weights}, CPU: loss {cpu_loss:.8f}; smallest top-k magnitude gap "
              f"{cpu_margin:.3e}; to_tokens.weight vs float64 from its own upstream gradient "
              f"{w_error(cpu_grads, cpu_dy):.3e}")
        # flags() sets every flag it is not given to its own default: name them all.
        for name, cudnn in (("cuDNN default", {}),
                            ("cudnn.deterministic", dict(enabled=True, deterministic=True,
                                                         allow_tf32=False)),
                            ("cuDNN off", dict(enabled=False, allow_tf32=False))):
            with torch.backends.cudnn.flags(**cudnn) if cudnn else contextlib.nullcontext():
                loss, grads, _, picks, margin, dy = mgfn_step(model_on(device), p, batch, device)
            worst = sorted(((rel(grads[k], cpu_grads[k]), k) for k in grads), reverse=True)[:3]
            print(f"[mgfn] {weights}, card, {name}: loss rel {abs(loss - cpu_loss) / abs(cpu_loss):.3e};"
                  f" videos whose top-k picks differ from the CPU's "
                  f"{int((picks != cpu_picks).any(dim=1).sum())}; worst gradients vs CPU "
                  f"{', '.join(f'{k} {e:.3e}' for e, k in worst)}; to_tokens upstream gradient vs "
                  f"CPU {rel(dy, cpu_dy):.3e}; to_tokens.weight vs float64 from its own upstream "
                  f"gradient {w_error(grads, dy):.3e}")


# K3 against its plain version: (name, (clips, frames, H, W), rows carry the tag byte,
# byte offset of the batch in its buffer). The serving batch with rows mixing all four
# colour sets; rows without a tag; the serving batch at an odd base address (every row
# unaligned); a small frame; then each frame that takes another instantiation, tagged
# and untagged, at odd base addresses: ShanghaiTech's native 480x856 and 360x640
# (<4, 32, 2, 16>), 720p and 1080p (<8, 64, 4, 32>); a 10x downscale past every
# compile-time instantiation (the runtime-taps kernel).
K3_CASES = (
    ("serving, four colour sets", (16, 16, 240, 320), True, 0),
    ("serving, untagged rows", (2, 16, 240, 320), False, 0),
    ("480x856", (2, 8, 480, 856), True, 0),
    ("serving at base + 1 B", (2, 16, 240, 320), True, 1),
    ("40x80", (2, 3, 40, 80), True, 0),
    ("480x856 at base + 3 B, untagged", (2, 4, 480, 856), False, 3),
    ("360x640 at base + 1 B", (4, 2, 360, 640), True, 1),
    ("720x1280 at base + 5 B", (4, 1, 720, 1280), True, 5),
    ("1080x1920 at base + 1 B", (4, 1, 1080, 1920), True, 1),
    ("1080x1920 at base + 7 B, untagged", (1, 2, 1080, 1920), False, 7),
    ("runtime taps, 2240x2240 at base + 1 B", (1, 2, 2240, 2240), True, 1),
)
K3_MISALIGNED = (1, 2, 50, 70)  # 0.8 of 50 rows starts at row 5: refused
# K3 timed beside the serving batch: the frames of the other instantiations, bf16 out.
K3_FRAME_SIZES = ((16, 16, 480, 856), (16, 16, 360, 640), (4, 16, 720, 1280), (4, 16, 1080, 1920))
# F.interpolate's own filter arithmetic on 0..255 planes, through the colour matrix.
K3_INTERPOLATE_TOL = 5e-4

# K4 against its plain version, bit for bit: (name, x shape NHWC / NDHWC, kernel shape
# HWIO / DHWIO, strides, pads, lhs dilation). The ragged cases of the int8 path beside the
# shapes chip_smoke.py records from it: Cin 3 (the I3Res50 stem through K4), odd H/W, stride
# 2, the (3, 1, 1) temporal taps, the up2_int8 4x4 form, a ragged Cout and Cin 48, wide
# Cout, asymmetric pads; the 3x3 kernel's ragged tiles (odd H/W, a 3D conv of depth
# slices, Cin 32 in one stage).
K4_CASES = (
    ("3x3 64->64 at 56^2", (2, 56, 56, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1)), None),
    ("stem Cin 3 (5,7,7) s2", (1, 8, 32, 32, 3), (5, 7, 7, 3, 64), (2, 2, 2),
     ((2, 2), (3, 3), (3, 3)), None),
    ("odd H/W, Cin 48, Cout 40", (2, 13, 17, 48), (3, 3, 48, 40), (1, 1), ((1, 1), (1, 1)), None),
    ("3x3 stride 2", (2, 57, 55, 64), (3, 3, 64, 128), (2, 2), ((1, 1), (1, 1)), None),
    ("1x1 stride 2", (2, 28, 28, 64), (1, 1, 64, 128), (2, 2), ((0, 0), (0, 0)), None),
    ("(3,1,1) temporal", (2, 8, 14, 14, 256), (3, 1, 1, 256, 64), (1, 1, 1),
     ((1, 1), (0, 0), (0, 0)), None),
    ("(1,3,3) stride 2", (2, 4, 15, 15, 128), (1, 3, 3, 128, 128), (1, 2, 2),
     ((0, 0), (1, 1), (1, 1)), None),
    ("(1,3,3) unstrided, Cout 72", (2, 3, 13, 19, 64), (1, 3, 3, 64, 72), (1, 1, 1),
     ((0, 0), (1, 1), (1, 1)), None),
    ("3x3 Cin 32 at 30x36", (2, 30, 36, 32), (3, 3, 32, 32), (1, 1), ((1, 1), (1, 1)), None),
    ("up2_int8 4x4 dilated", (2, 28, 28, 64), (4, 4, 64, 32), (1, 1), ((2, 2), (2, 2)), (2, 2)),
    ("1x1x1 512->2048", (1, 2, 7, 7, 512), (1, 1, 1, 512, 2048), (1, 1, 1),
     ((0, 0), (0, 0), (0, 0)), None),
    ("asymmetric pads", (1, 9, 10, 32), (3, 3, 32, 24), (1, 1), ((0, 2), (1, 0)), None),
)
INT8_TOPS = 1979e12  # H100 SXM dense int8 tensor-core rate
# The unstrided 2D 3x3 class of an int8 serving step (23 of its 79 convs, most of K4's
# time), as record_int8_convs finds it at 16 clips of 224^2 frames: (site, x shape,
# kernel shape, epilogue form); stride 1, pads 1.
K4_SERVING_3X3 = (
    ("enc_layer1_0.conv1", (256, 56, 56, 64), (3, 3, 64, 64), "bn+relu->int8"),
    ("enc_layer1_0.conv2", (256, 56, 56, 64), (3, 3, 64, 64), "bn+res(int8)+relu->int8"),
    ("enc_layer1_1.conv1", (256, 56, 56, 64), (3, 3, 64, 64), "bn+relu->int8"),
    ("enc_layer1_1.conv2", (256, 56, 56, 64), (3, 3, 64, 64), "bn+res(int8)+relu->int8"),
    ("enc_layer2_0.conv2", (256, 28, 28, 128), (3, 3, 128, 128), "bn+res+relu->int8"),
    ("enc_layer2_1.conv1", (256, 28, 28, 128), (3, 3, 128, 128), "bn+relu->int8"),
    ("enc_layer2_1.conv2", (256, 28, 28, 128), (3, 3, 128, 128), "bn+res(int8)+relu->int8"),
    ("enc_layer3_0.conv2", (256, 14, 14, 256), (3, 3, 256, 256), "bn+res+relu->int8"),
    ("enc_layer3_1.conv1", (256, 14, 14, 256), (3, 3, 256, 256), "bn+relu->int8"),
    ("enc_layer3_1.conv2", (256, 14, 14, 256), (3, 3, 256, 256), "bn+res(int8)+relu->int8"),
    ("sk_f1", (256, 28, 28, 128), (3, 3, 128, 256), "dequant"),
    ("x_0_0.conv2", (256, 28, 28, 256), (3, 3, 256, 256), "bn+relu->int8"),
    ("sk_f2", (256, 56, 56, 64), (3, 3, 64, 192), "dequant"),
    ("sk_f3", (256, 112, 112, 64), (3, 3, 64, 192), "dequant"),
    ("x_1_1.conv2", (256, 56, 56, 64), (3, 3, 64, 64), "bn+relu->int8"),
    ("x_2_2.conv2", (256, 112, 112, 64), (3, 3, 64, 64), "bn+relu->int8"),
    ("sk_x22", (256, 112, 112, 64), (3, 3, 64, 128), "dequant"),
    ("sk_x11", (256, 56, 56, 64), (3, 3, 64, 128), "dequant"),
    ("x_0_1.conv2", (256, 56, 56, 128), (3, 3, 128, 128), "bn+relu->int8"),
    ("x_1_2.conv2", (256, 112, 112, 64), (3, 3, 64, 64), "bn+relu->int8"),
    ("sk_x12", (256, 112, 112, 64), (3, 3, 64, 64), "dequant"),
    ("x_0_2.conv2", (256, 112, 112, 64), (3, 3, 64, 64), "bn+relu->int8"),
    ("x_0_3.conv2", (256, 224, 224, 32), (3, 3, 32, 32), "bn+relu"),
)
# K4's epilogue forms, by ``Epilogue.form()``: (conv bias, BatchNorm, residual: None /
# "dtype" / "int8", ReLU, int8 output). Where each runs on the int8 path: the UNet++ skip
# convs; the downsamples; BasicBlock conv1, Bottleneck3D conv1 / conv2 and the decoder's
# conv2 (its ConvBN has no bias); conv2 / conv3 after a downsample; conv2 / conv3 on the
# identity; the I3Res50's last conv3 (on the identity, or after a downsample in a layout
# whose last block has one); x_0_3's conv2; and with a conv bias, a decoder conv2 of a
# module whose conv2 has one.
K4_FORMS = {
    "dequant": (False, False, None, False, False),
    "bn": (False, True, None, False, False),
    "bn+relu->int8": (False, True, None, True, True),
    "bn+res+relu->int8": (False, True, "dtype", True, True),
    "bn+res(int8)+relu->int8": (False, True, "int8", True, True),
    "bn+res(int8)+relu": (False, True, "int8", True, False),
    "bn+res+relu": (False, True, "dtype", True, False),
    "bn+relu": (False, True, None, True, False),
    "bias+bn+relu->int8": (True, True, None, True, True),
    "bias+bn+relu": (True, True, None, True, False),
}


def yuv_rows(device, shape, tagged: bool, offset: int = 0, seed: int = 0):
    """Seeded packed [Y | U | V (| tag)] rows (clips, frames, L) on the card; with
    ``tagged`` clip i's rows carry tag i % 4 (all four colour sets); ``offset`` > 0 puts
    the batch that many bytes into a buffer."""
    import numpy as np
    import torch

    from ted_spad_tpu_torch.ops.yuv import packed_row_bytes

    b, t, h, w = shape
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (b, t, packed_row_bytes(h, w) + int(tagged)), dtype=np.uint8)
    if tagged:
        data[:, :, -1] = (np.arange(b) % 4)[:, None]
    buf = torch.empty(data.size + offset, dtype=torch.uint8, device=device)
    rows = buf[offset:].view(data.shape)
    rows.copy_(torch.from_numpy(data))
    return rows


def yuv_plain(rows, hw, out_dtype, out_h: int = 224, out_w: int = 224):
    from ted_spad_tpu_torch.ops import yuv

    y, u, v, bt709, full = yuv.unpack_yuv(rows, hw)
    return yuv.fused_preprocess_yuv_reference(y, u, v, out_h=out_h, out_w=out_w,
                                              out_dtype=out_dtype, bt709=bt709, full=full)


def k3_check(device, log=print) -> float:
    """K3 against fused_preprocess_yuv_reference (TF32 off) at every K3_CASES entry, f32
    within K1_F32_TOL and bf16 within K1_BF16_TOL of max|plain|, and its refusal of a
    chroma-misaligned window. Returns the worst max abs error."""
    import torch

    from ted_spad_tpu_torch.ops import yuv
    from ted_spad_tpu_torch.utils.device import tf32_off

    worst = 0.0
    for i, (name, shape, tagged, offset) in enumerate(K3_CASES):
        rows = yuv_rows(device, shape, tagged, offset, seed=40 + i)
        hw = shape[2:]
        plan = yuv.k3_plan(*hw)
        for dtype, tol in ((torch.float32, K1_F32_TOL), (torch.bfloat16, K1_BF16_TOL)):
            got = yuv.fused_preprocess_yuv(rows, hw, out_dtype=dtype)
            with tf32_off():
                ref = yuv_plain(rows, hw, dtype)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            log(f"[K3] {name} {shape} {str(dtype)[6:]} ({plan.kernel}, {plan.band_rows} rows, "
                f"{plan.smem_bytes} B): max|kernel - plain| = {err:.3e}, {err / scale:.3e} of "
                f"max|plain| (tolerance {tol:.3e})")
            if not (got.shape == ref.shape and err <= tol * scale):
                raise AssertionError(f"K3 disagrees with its plain version at {name}: {err}")
            worst = max(worst, err)
    rows = yuv_rows(device, K3_MISALIGNED, True)
    try:
        yuv.fused_preprocess_yuv(rows, K3_MISALIGNED[2:])
    except ValueError as e:
        log(f"[K3] {K3_MISALIGNED}: refused, as the plain version is ({e})")
    else:
        raise AssertionError("K3 took a chroma-misaligned window")
    return worst


def k3_bound(shape, out_bytes: int, out_h: int = 224, out_w: int = 224):
    """(bytes, f32 FLOP) of the YUV preprocess of one batch: each window byte of the
    three planes read once, the output written once; per plane one multiply-add per
    nonzero tap of R_y over the window's columns and of R_x over the output rows, and
    the colour transform's ~12 operations per output pixel."""
    import numpy as np

    from ted_spad_tpu_torch.ops import yuv

    b, t, h, w = shape
    ry, rx, cry, crx = yuv.yuv_matrices(h, w, out_h, out_w, 0.8)
    read = flops = 0
    for my, mx, planes in ((ry, rx, 1), (cry, crx, 2)):
        rows, cols = int(my.any(axis=0).sum()), int(mx.any(axis=0).sum())
        read += planes * rows * cols
        flops += planes * 2 * (np.count_nonzero(my) * cols + np.count_nonzero(mx) * out_h)
    n = b * t
    return n * (read + out_h * out_w * 3 * out_bytes), n * (flops + 12 * out_h * out_w)


def yuv_interpolate(rows, hw, out_h: int = 224, out_w: int = 224, out_dtype=None):
    """The library yardstick of K3: each plane's window resized by F.interpolate
    (antialiased bilinear), then the same colour transform, in ``out_dtype`` (bf16 by
    default). Never called by the port."""
    import torch
    import torch.nn.functional as F

    from ted_spad_tpu_torch.ops import yuv

    y, u, v, bt709, full = yuv.unpack_yuv(rows, hw)
    y0, x0, ch, cw = yuv.yuv_window(*hw, 0.8)

    def resize(p, top, left, hh, ww):
        b, t = p.shape[:2]
        win = p[..., top : top + hh, left : left + ww].reshape(b * t, 1, hh, ww).float()
        out = F.interpolate(win, size=(out_h, out_w), mode="bilinear", align_corners=False,
                            antialias=True)
        return out.reshape(b, t, out_h, out_w)

    yf = resize(y, y0, x0, ch, cw)
    uf = resize(u, y0 // 2, x0 // 2, ch // 2, cw // 2) - 128.0
    vf = resize(v, y0 // 2, x0 // 2, ch // 2, cw // 2) - 128.0
    idx = (bt709.long() + 2 * full.long()) if bt709 is not None else torch.zeros(
        y.shape[0], dtype=torch.long, device=y.device)
    c = {k: torch.tensor([s[k] for s in yuv.COLOR_SETS], device=y.device)[idx].view(-1, 1, 1, 1)
         for k in yuv.BT601_LIMITED}
    yy = c["ky"] * (yf - c["y_off"])
    rgb = torch.stack([yy + c["rv"] * vf, yy + c["gu"] * uf + c["gv"] * vf, yy + c["bu"] * uf],
                      dim=-1) / 255.0
    return rgb.clamp(0.0, 1.0).to(out_dtype or torch.bfloat16)


def k3_timing(device, log=print, shape=K3_CASES[0][1]) -> dict:
    """K3 alone at ``shape`` (the serving batch, rows mixing the four colour sets), bf16
    out, beside its bound, its plain version and the F.interpolate yardstick (held
    against the plain version first). Returns K3's entry of the kernel table, launches
    aside."""
    import torch

    from ted_spad_tpu_torch.ops import yuv
    from ted_spad_tpu_torch.utils.device import tf32_off

    rows = yuv_rows(device, shape, True, seed=99)
    hw = shape[2:]
    with tf32_off():
        ref = yuv_plain(rows, hw, torch.float32)
    interp_err = float((yuv_interpolate(rows, hw, out_dtype=torch.float32) - ref).abs().max())
    log(f"[K3] per-plane F.interpolate + colour matrix (f32) vs plain at {shape}: max abs error "
        f"{interp_err:.3e} (tolerance {K3_INTERPOLATE_TOL:.0e})")
    if not interp_err <= K3_INTERPOLATE_TOL:
        raise AssertionError(f"the interpolate yardstick does not compute K3's function: {interp_err}")
    del ref
    ms = time_ms(lambda: yuv.fused_preprocess_yuv(rows, hw))
    device_ms = time_ms(lambda: yuv.fused_preprocess_yuv(rows, hw), queued=True)
    with tf32_off():
        plain_ms = time_ms(lambda: yuv_plain(rows, hw, torch.bfloat16), reps=5, inner=1)
    library_ms = time_ms(lambda: yuv_interpolate(rows, hw), reps=5, inner=1)
    bytes_moved, flops = k3_bound(shape, out_bytes=2)
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound_ms = max(by_bytes, by_ops)
    plan = yuv.k3_plan(*hw)
    log(f"[K3] {shape} bf16 ({plan.kernel}, {plan.band_rows} rows, {plan.smem_bytes} B): kernel "
        f"{ms:.4f} ms (device only {device_ms:.4f}) = {bytes_moved / ms * 1e-6:.1f} GB/s, "
        f"{ms / bound_ms:.2f}x the bound {bound_ms:.4f} ms ({bytes_moved} B; {flops} f32 FLOP = "
        f"{by_ops:.4f} ms); plain {plain_ms:.4f} ms, F.interpolate per plane + colour matrix "
        f"{library_ms:.4f} ms")
    return {
        "name": "K3 preprocess_yuv", "route": "cuda",
        "source": "ted_spad_tpu_torch/csrc/preprocess_yuv.cu",
        "replaces": "ted_spad_tpu/ops/yuv.py:42 (fused_preprocess_yuv; XLA, no Pallas kernel)",
        "ms": ms, "device_only_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if by_bytes >= by_ops else "operations", "library_ms": library_ms,
        "kernel": plan.kernel,
    }


def k3_register_report(nvcc_out: str, log=print, strict: bool = True) -> dict[str, dict[str, int]]:
    """Each K3 instantiation's registers and spill bytes from nvcc's ptxas report,
    logged and keyed "bf16 K3<KY, SPAN, KYC, SPANC>" (``k3_plan(...).kernel`` with the
    output type), each beside the blocks per SM that the plans taking it count on;
    ``strict``: raises if one spills or needs more registers than those blocks allow."""
    from ted_spad_tpu_torch.ops import yuv
    from ted_spad_tpu_torch.ops.preprocess import REGISTERS_PER_SM
    from ted_spad_tpu_torch.utils import cuda_build

    # (an older package, timed by k3ab, may state no blocks per SM)
    blocks = {"K3<{}, {}, {}, {}>".format(*t[:4]): t[4] for t in yuv.K3_TAPS if len(t) == 5}
    blocks["K3<runtime>"] = getattr(yuv, "K3_BLOCKS_PER_SM", None)
    report = {}
    for name, r in cuda_build.ptxas_report(nvcc_out).items():
        m = re.search(r"preprocess_yuv_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", name)
        if not m:
            continue
        taps = m.group(2, 3, 4, 5)
        kernel = "K3<runtime>" if taps[0] == "0" else f"K3<{', '.join(taps)}>"
        label = f"{'f32' if m.group(1) == 'f' else 'bf16'} {kernel}"
        report[label] = r
        n = blocks.get(kernel)
        log(f"[K3 build] {label}: {r['registers']} registers, spill stores {r['spill_stores']} B, "
            f"spill loads {r['spill_loads']} B; the plan counts on {n or 'no stated number of'} "
            f"blocks per SM")
        if strict and (r["spill_stores"] or r["spill_loads"]):
            raise AssertionError(f"K3 {label} spills registers: {r}")
        if strict and n and n * 256 * (-(-r["registers"] // 8) * 8) > REGISTERS_PER_SM:
            raise AssertionError(f"K3 {label} needs {r['registers']} registers: the {n} blocks "
                                 f"per SM its plans count on do not fit")
    return report


def k3_time(device, shape) -> tuple[float, float, object]:
    """K3 alone at ``shape`` (tagged rows, bf16 out): (event ms, device-only ms, plan)."""
    from ted_spad_tpu_torch.ops import yuv

    rows = yuv_rows(device, shape, True, seed=99)
    hw = shape[2:]
    ms = time_ms(lambda: yuv.fused_preprocess_yuv(rows, hw))
    device_ms = time_ms(lambda: yuv.fused_preprocess_yuv(rows, hw), queued=True)
    return ms, device_ms, yuv.k3_plan(*hw)


def k3(device) -> None:
    from ted_spad_tpu_torch.utils import cuda_build

    seconds, nvcc_out = cuda_build.build("preprocess_yuv")
    k3_register_report(nvcc_out)
    print(f"build {seconds:.2f}s", flush=True)
    print(f"worst max abs error {k3_check(device):.3e}", flush=True)
    k3_timing(device)
    for shape in K3_FRAME_SIZES:
        k3_timing(device, shape=shape)


def k3_turn(device, mode: str = "check") -> None:
    """One turn of ``k3ab``, under whichever package the import path finds: K3's build
    report, its check at K3_CASES (not in ``mode`` "timing", for diagnostic forms that
    compute something else), its event and device-only times at the serving batch and at
    K3_FRAME_SIZES; the readings as one JSON line."""
    import json

    from ted_spad_tpu_torch.utils import cuda_build

    registers = k3_register_report(cuda_build.build("preprocess_yuv")[1], log=lambda m: None,
                                   strict=False)
    worst = k3_check(device, log=lambda m: None) if mode == "check" else float("nan")
    times = {}
    for shape in (K3_CASES[0][1],) + K3_FRAME_SIZES:
        ms, device_ms, plan = k3_time(device, shape)
        bound = k3_bound(shape, out_bytes=2)[0] / HBM_BYTES_PER_S * 1e3
        times["x".join(map(str, shape[2:]))] = dict(
            ms=ms, device_only_ms=device_ms, bound_ms=bound, kernel=plan.kernel,
            band_rows=plan.band_rows, smem_bytes=plan.smem_bytes)
    print(json.dumps({"worst_err": worst, "registers": registers, "times": times}), flush=True)


def k3ab(device, *trees: str) -> None:
    """K3 from several copies of the package (e.g. the parent's from git archive and
    stages of a change, each unpacked under ``build/``), one turn each in the order
    given (parent, change, change, parent), each turn a process of its own under that
    copy's package and kernel: the copies' kernels are built first, in parallel; each
    turn checks K3 at K3_CASES and times it at the serving batch and K3_FRAME_SIZES. A
    copy given as ``DIR:timing`` (a diagnostic form) is timed without the check."""
    import json
    import os
    import subprocess

    modes = ["timing" if t.endswith(":timing") else "check" for t in trees]
    roots = [os.path.abspath(t.removesuffix(":timing")) for t in trees]
    code = "from ted_spad_tpu_torch.utils.cuda_build import build; build('preprocess_yuv')"
    builds = {r: subprocess.Popen([sys.executable, "-c", code], cwd=r,
                                  env={**os.environ, "PYTHONPATH": r}, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
              for r in dict.fromkeys(roots)}
    failed = set()
    for r, proc in builds.items():
        out = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            print(f"[k3ab] the build under {r} failed:\n{out[-3000:]}", flush=True)
            failed.add(r)
    turn = ("import runpy, sys; sys.argv = ['chip_probes', 'k3turn', sys.argv[1]]; "
            f"runpy.run_path({os.path.abspath(__file__)!r}, run_name='__main__')")
    for i, root in enumerate(roots):
        if root in failed:
            continue
        proc = subprocess.run([sys.executable, "-c", turn, modes[i]], cwd=root,
                              env={**os.environ, "PYTHONPATH": root}, capture_output=True,
                              text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"worst_err"')]
        if proc.returncode != 0 or not lines:
            print(f"[k3ab] turn {i} {trees[i]} failed (exit {proc.returncode}):\n"
                  f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}", flush=True)
            continue
        reading = json.loads(lines[-1])
        regs = ", ".join(f"{k} {v['registers']}" + (f" (spills {v['spill_stores']} / {v['spill_loads']} B)"
                                                     if v["spill_stores"] or v["spill_loads"] else "")
                         for k, v in reading["registers"].items())
        print(f"[k3ab] turn {i} {trees[i]}: worst error {reading['worst_err']:.3e}; registers {regs}",
              flush=True)
        for frame, t in reading["times"].items():
            print(f"[k3ab]     {frame:>9}: {t['ms']:.4f} ms (device only {t['device_only_ms']:.4f}), bound "
                  f"{t['bound_ms']:.4f} ({t['device_only_ms'] / t['bound_ms']:.2f}x); {t['kernel']}, "
                  f"{t['band_rows']} rows, {t['smem_bytes']} B", flush=True)


def k2_turn(device) -> None:
    """One turn of ``k2ab``, under whichever package the import path finds: K2's build
    report and its float32 form's error and times at the nine DoubleConvs of one
    VIS_CHUNK chunk, as one JSON line."""
    import json

    from ted_spad_tpu_torch.utils import cuda_build

    registers = k2_register_report(cuda_build.build("doubleconv")[1], log=lambda m: None,
                                   strict=False)
    rows = k2_f32_chunk_times(device)
    print(json.dumps({"registers": {k: v for k, v in registers.items() if k.startswith("f32")},
                      "rows": rows}), flush=True)


def k2ab(device, *trees: str) -> None:
    """K2's float32 form of other checkouts in turns, each turn a process of its own
    (``k2_turn``) under that tree's package and kernel, every tree built first, all at
    once. One tree (e.g. the parent commit from git archive, unpacked under ``build/``):
    it and this tree in turns, parent / change / change / parent, and whether the change
    was faster in every turn. Several (e.g. copies of the package, each with one edit of
    csrc/doubleconv.cu): each once, in the order given."""
    import json
    import os
    import subprocess

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if len(trees) == 1:
        parent = os.path.abspath(trees[0])
        turns = [("parent", parent), ("change", here), ("change", here), ("parent", parent)]
    else:
        turns = [(t, os.path.abspath(t)) for t in trees]
    code = "from ted_spad_tpu_torch.utils.cuda_build import build; build('doubleconv')"
    builds = {root: subprocess.Popen([sys.executable, "-c", code], cwd=root,
                                     env={**os.environ, "PYTHONPATH": root}, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
              for root in dict.fromkeys(root for _, root in turns)}
    for root, proc in builds.items():
        out = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"k2ab: the build under {root} failed:\n{out[-3000:]}")
    turn = ("import runpy, sys; sys.argv = ['chip_probes', 'k2turn']; "
            f"runpy.run_path({os.path.abspath(__file__)!r}, run_name='__main__')")
    totals = {}
    for i, (tag, root) in enumerate(turns):
        proc = subprocess.run([sys.executable, "-c", turn], cwd=root,
                              env={**os.environ, "PYTHONPATH": root}, capture_output=True,
                              text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"registers"')]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"k2ab turn {i} ({tag}) failed (exit {proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        reading = json.loads(lines[-1])
        rows = reading["rows"]
        total = {k: sum(r[k] for r in rows) for k in ("ms", "device_only_ms", "flops")}
        worst = max(r["max_rel_err"] for r in rows)
        totals.setdefault(tag, []).append(total["ms"])
        regs = ", ".join(f"{k} {v['registers']}" + (f" (spills {v['spill_stores']} / {v['spill_loads']} B)"
                                                     if v["spill_stores"] or v["spill_loads"] else "")
                         for k, v in reading["registers"].items())
        print(f"[k2ab] turn {i} {tag}: the nine f32 DoubleConvs of one {VIS_CHUNK} chunk "
              f"{total['ms']:.3f} ms ({total['device_only_ms']:.3f} device-only, "
              f"{total['flops'] / total['device_only_ms'] * 1e-9:.1f} TFLOP/s); worst error "
              f"{worst:.3e} of max|plain|; registers {regs}", flush=True)
        for r in rows:
            print(f"[k2ab]     {r['block']:>6} {r['shape']}: {r['ms']:.3f} ms "
                  f"({r['device_only_ms']:.3f} device-only)", flush=True)
        if not worst <= K2_F32_TOL:
            raise AssertionError(f"k2ab turn {i} ({tag}): K2's float32 form disagrees: {worst}")
    if len(trees) == 1:
        faster = max(totals["change"]) < min(totals["parent"])
        print(f"[k2ab] change {totals['change']} ms against parent {totals['parent']} ms: "
              f"{'faster in every turn' if faster else 'NOT faster in every turn'}", flush=True)


def k4_operands(device, x_shape, w_shape, seed: int = 0):
    """Seeded int8 activations (codes in [-127, 127]) and a float kernel quantized and
    packed for K4, on the card."""
    import numpy as np
    import torch

    from ted_spad_tpu_torch.ops.int8conv import int8_weight

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, x_shape, dtype=np.int8)).to(device)
    w = torch.from_numpy(rng.standard_normal(w_shape).astype(np.float32)).to(device)
    return x, int8_weight(w)


def k4_epilogue(form: str, weight, out_shape, dtype, device, seed: int = 0,
                act_scale: float = 0.05):
    """Seeded operands of one of ``K4_FORMS`` for a conv of ``weight`` writing
    ``out_shape``, at the scale of its outputs: y's std is about act_scale * 73.3 (the
    std of uniform codes) * sqrt(K) * std(w codes * w scale); the BatchNorm scales lie
    in [0.5, 1.5], the biases near 0.3 of y's std, a residual near y's std, and int8
    outputs are coded at 4 std / 127."""
    import math

    import numpy as np
    import torch

    from ted_spad_tpu_torch.ops.int8conv import Epilogue

    bias, bn, res, relu, int8_out = K4_FORMS[form]
    codes = weight.codes.float()
    k = math.prod(codes.shape[:-1])
    y_std = act_scale * 73.3 * math.sqrt(k) * float((codes * weight.scale.to(codes.device)).std())
    rng = np.random.default_rng(seed)
    cout = out_shape[-1]

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dt)

    ep = Epilogue(relu=relu, out_scale=4 * y_std / 127 if int8_out else None)
    if bias:
        ep = ep._replace(bias=t(rng.normal(0, 0.3 * y_std, cout).astype(np.float32)))
    if bn:
        ep = ep._replace(bn=(t(rng.uniform(0.5, 1.5, cout).astype(np.float32)),
                             t(rng.normal(0, 0.3 * y_std, cout).astype(np.float32))))
    if res == "dtype":
        ep = ep._replace(residual=t(rng.normal(0, y_std, out_shape).astype(np.float32)))
    elif res == "int8":
        ep = ep._replace(residual=t(rng.integers(-127, 128, out_shape, dtype=np.int8), torch.int8),
                         residual_scale=y_std / 73.3)
    return ep


def k4_call(x, weight, strides, padding, dilation, use_kernel: bool = True, scale: float = 0.05,
            out_dtype=None, epilogue=None):
    import torch

    from ted_spad_tpu_torch.ops.int8conv import int8_conv

    return int8_conv(x, weight, scale, strides=strides, padding=padding, lhs_dilation=dilation,
                     out_dtype=out_dtype or torch.bfloat16, epilogue=epilogue,
                     use_kernel=use_kernel)


def k4_check(device, cases, log=print, tag: str = "[K4]") -> int:
    """K4 against int8_conv_reference on the card, bf16 and f32, bit for bit, at each
    (name, x shape, kernel shape, strides, pads, dilation[, epilogue form]) of
    ``cases``: with its form where the case names one, else with each of K4_FORMS.
    Returns the number of elements compared."""
    import torch

    from ted_spad_tpu_torch.ops.int8conv import conv_out_shape

    n = 0
    for i, (name, xs, ws, st, pads, dil, *form) in enumerate(cases):
        x, weight = k4_operands(device, xs, ws, seed=60 + i)
        out_shape = conv_out_shape(xs, ws, strides=st, padding=pads, lhs_dilation=dil)
        for dtype in (torch.bfloat16, torch.float32):
            same_all, sizes = True, 0
            for f in form or K4_FORMS:
                ep = k4_epilogue(f, weight, out_shape, dtype, device, seed=i)
                got = k4_call(x, weight, st, pads, dil, out_dtype=dtype, epilogue=ep)
                ref = k4_call(x, weight, st, pads, dil, use_kernel=False, out_dtype=dtype,
                              epilogue=ep)
                torch.cuda.synchronize()
                same = got.shape == ref.shape and got.dtype == ref.dtype and torch.equal(got, ref)
                if not same:
                    diff = int((got != ref).sum()) if got.shape == ref.shape else -1
                    log(f"{tag} {name} {f} {str(dtype)[6:]}: {diff} of {ref.numel()} elements differ")
                    raise AssertionError(f"K4 differs from its plain version at {name}, {f}, {dtype}")
                sizes += got.numel()
            log(f"{tag} {name} x{tuple(xs)} w{tuple(ws)} s{tuple(st)} p{tuple(pads)} d{dil} "
                f"{str(dtype)[6:]}: bit-equal in {len(form or K4_FORMS)} form(s) "
                f"{' '.join(form) if form else ''}({sizes} elements)")
            n += sizes
    return n


def k4_bound(x_shape, w_shape, out_shape, form: str = "dequant",
             ct_bytes: int = 2) -> tuple[float, float]:
    """(ms by operations, ms by bytes) of one int8 conv with its epilogue ``form``: 2 *
    taps * Cin * Cout operations per output pixel at the int8 tensor-core rate; at the
    memory rate, the activations, the weights, the float32 channel scales and the
    form's channel vectors (bias, BatchNorm scale and bias, ``ct_bytes`` each) read
    once, its residual read once (``ct_bytes`` or 1 byte a value), and the output
    written once (1 byte a value where it is requantized, else ``ct_bytes``)."""
    import math

    bias, bn, res, _, int8_out = K4_FORMS[form]
    taps_cin = math.prod(w_shape[:-1])
    cout = w_shape[-1]
    m = math.prod(out_shape[:-1])
    ops = 2 * m * taps_cin * cout
    vectors = 4 * cout + ct_bytes * cout * (int(bias) + 2 * int(bn))
    res_bytes = {None: 0, "dtype": ct_bytes, "int8": 1}[res]
    bytes_moved = (math.prod(x_shape) + taps_cin * cout + vectors
                   + m * cout * (res_bytes + (1 if int8_out else ct_bytes)))
    return ops / INT8_TOPS * 1e3, bytes_moved / HBM_BYTES_PER_S * 1e3


def k4_library(x, weight, strides, padding, dilation, scale: float = 0.05, epilogue=None):
    """The yardsticks of one int8 conv shape, never called by the port: (the cuDNN bf16
    conv it replaces, on the dequantized operands, without the epilogue; torch._int_mm +
    the dequant and ``epilogue``'s torch ops at a 1x1 / 1x1x1 unstrided, unpadded shape,
    else None), each a zero-argument callable."""
    import torch
    import torch.nn.functional as F

    from ted_spad_tpu_torch.ops.int8conv import Epilogue, channel_scale, dequant_sums, finish

    nd = weight.codes.dim() - 2
    fmt = torch.channels_last if nd == 2 else torch.channels_last_3d
    xb = x.to(torch.bfloat16).movedim(-1, 1)  # NCHW / NCDHW view in channels_last memory
    wb = (weight.codes.to(torch.bfloat16) * weight.scale.to(torch.bfloat16)).permute(
        nd + 1, nd, *range(nd)).contiguous(memory_format=fmt)
    pads = [p for pair in reversed([tuple(p) for p in padding]) for p in pair]
    if dilation is not None and any(d != 1 for d in dilation):
        # lhs dilation as a transposed conv of the flipped kernel (pad k - 1 - p per side).
        wt = wb.flip(list(range(2, 2 + nd))).transpose(0, 1).contiguous(memory_format=fmt)
        k = weight.codes.shape[0]
        conv_t = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
        cudnn = lambda: conv_t(xb, wt, stride=tuple(dilation),  # noqa: E731
                               padding=k - 1 - padding[0][0])
    else:
        conv = F.conv2d if nd == 2 else F.conv3d
        symmetric = all(lo == hi for lo, hi in padding)
        if symmetric:
            cudnn = lambda: conv(xb, wb, stride=tuple(strides),  # noqa: E731
                                 padding=tuple(lo for lo, _ in padding))
        else:
            cudnn = lambda: conv(F.pad(xb, pads), wb, stride=tuple(strides))  # noqa: E731
    int_mm = None
    if all(k == 1 for k in weight.taps) and all(s == 1 for s in strides) and not any(pads):
        a = x.reshape(-1, x.shape[-1])
        b = weight.codes.reshape(x.shape[-1], -1).t().contiguous().t()  # column-major (K, N)
        sc = channel_scale(scale, weight.scale)
        ep = epilogue or Epilogue()
        if ep.residual is not None:
            ep = ep._replace(residual=ep.residual.reshape(a.shape[0], -1))
        if a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0:
            int_mm = lambda: finish(dequant_sums(torch._int_mm(a, b), sc, torch.bfloat16), ep)  # noqa: E731
    return cudnn, int_mm


def epilogue_form(bias=None, bn=None, residual=None, relu: bool = False,
                  out_site: str | None = None) -> str:
    """``Epilogue.form()`` of a ``_Quantizer.conv`` call from its epilogue arguments."""
    from ted_spad_tpu_torch.ops.int8conv import Epilogue
    from ted_spad_tpu_torch.ops.quant_unetpp import QT

    int8_res = isinstance(residual, QT)
    return Epilogue(bias=bias, bn=None if bn is None else (bn, bn), residual=residual,
                    residual_scale=1.0 if int8_res else None, relu=relu,
                    out_scale=None if out_site is None else 1.0).form()


def record_int8_convs(step, batch) -> list:
    """The int8 convolutions one call of ``step`` runs, in order: (site key, input shape,
    kernel shape, strides, pads, lhs dilation, epilogue form), by wrapping
    ``_Quantizer.conv``."""
    from ted_spad_tpu_torch.ops import quant_unetpp

    calls = []
    original = quant_unetpp._Quantizer.conv

    def conv(self, qx, w, key, *, strides=(1, 1), padding=((1, 1), (1, 1)), lhs_dilation=None,
             **epilogue):
        out = original(self, qx, w, key, strides=strides, padding=padding,
                       lhs_dilation=lhs_dilation, **epilogue)
        if self.mode == "run":
            calls.append((key, tuple(qx.data.shape), tuple(self._weights[key].codes.shape),
                          tuple(strides), tuple(tuple(q) for q in padding), lhs_dilation,
                          epilogue_form(**epilogue)))
        return out

    quant_unetpp._Quantizer.conv = conv
    try:
        step(batch)
    finally:
        quant_unetpp._Quantizer.conv = original
    return calls


def conv_class(call) -> str:
    """A shape class of an int8 conv: its taps, stride and dilation."""
    _, xs, ws, st, _, dil, *_ = call
    taps = "x".join(map(str, ws[:-2]))
    stride = "" if all(v == 1 for v in st) else " s" + "x".join(map(str, st))
    return f"{len(ws) - 2}D {taps}{stride}{' up2' if dil else ''}"


def serving_int8_step(device, seed: int = 0):
    """(step, batch): the int8 serving step (UNet++ fa and I3Res50 ft, seeded random
    weights, quant="int8") calibrated on one batch of seeded random 16x16x240x320 clips,
    and that batch."""
    import numpy as np
    import torch

    import ted_spad_tpu_torch.stages.feature_extraction as fe
    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
    from ted_spad_tpu_torch.ops.quant_unetpp import act_scales_from_absmax

    p = FeatureExtractionParams(batch_size=16, quant="int8")
    fa, ft = load_fa_model(seed=0, device=device), load_ft_model(seed=0, device=device)
    batch = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (16, p.num_frames, 240, 320, 3), dtype=np.uint8)).to(device)
    stats = fe.make_fa_calibration_step(p, fa, ft, device=device)(batch)
    scales = act_scales_from_absmax({k: float(v) for k, v in stats.items()})
    return fe.make_extract_step(ft, p, fa, device=device, quant_act_scales=scales), batch


def k4_timing(device, calls, log=print, yardsticks: bool = False) -> list[dict]:
    """Each recorded conv timed alone at its full shape with its own epilogue form (seeded
    codes and operands, bf16), beside its bound and, with ``yardsticks``, its plain
    version, the cuDNN bf16 conv and (at the 1x1 / 1x1x1 unstrided shapes)
    ``torch._int_mm`` + the epilogue's torch ops. One row per conv."""
    import torch

    from ted_spad_tpu_torch.ops.int8conv import conv_out_shape

    rows = []
    for i, call in enumerate(calls):
        key, xs, ws, st, pads, dil, form = call
        x, weight = k4_operands(device, xs, ws, seed=200 + i)
        out_shape = conv_out_shape(xs, ws, strides=st, padding=pads, lhs_dilation=dil)
        ep = k4_epilogue(form, weight, out_shape, torch.bfloat16, device, seed=i)
        run = lambda: k4_call(x, weight, st, pads, dil, epilogue=ep)  # noqa: E731
        by_ops, by_bytes = k4_bound(xs, ws, out_shape, form)
        row = {"site": key, "class": conv_class(call), "form": form, "x": list(xs),
               "w": list(ws), "ms": time_ms(run, reps=3, inner=2),
               "device_only_ms": time_ms(run, reps=3, inner=2, queued=True),
               "bound_ms": max(by_ops, by_bytes),
               "bound_by": "operations" if by_ops >= by_bytes else "bytes"}
        line = (f"[K4] {key} ({row['class']}, {form}) x{list(xs)} w{list(ws)}: kernel "
                f"{row['ms']:.4f} ms (device only {row['device_only_ms']:.4f}), bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        if yardsticks:
            row["plain_ms"] = time_ms(lambda: k4_call(x, weight, st, pads, dil, use_kernel=False,
                                                      epilogue=ep), reps=1, inner=1)
            cudnn, int_mm = k4_library(x, weight, st, pads, dil, epilogue=ep)
            row["library_ms"] = time_ms(cudnn, reps=3, inner=2)
            line += f", plain {row['plain_ms']:.4f} ms, cuDNN bf16 {row['library_ms']:.4f} ms"
            if int_mm is not None:
                row["int_mm_ms"] = time_ms(int_mm, reps=3, inner=2)
                line += f", torch._int_mm + epilogue {row['int_mm_ms']:.4f} ms"
        log(line)
        rows.append(row)
        del x, weight, ep
    torch.cuda.empty_cache()
    return rows


def k4_classes(rows: list[dict]) -> dict:
    """Per shape class of ``k4_timing``'s rows: the count and the sums of each time."""
    by_class: dict = {}
    for row in rows:
        agg = by_class.setdefault(row["class"], {"n": 0})
        agg["n"] += 1
        for k, v in row.items():
            if k.endswith("_ms") or k == "ms":
                agg[k] = agg.get(k, 0.0) + v
    return dict(sorted(by_class.items(), key=lambda kv: -kv[1]["ms"]))


def k4class(device) -> None:
    """K4 alone at the 23 convs of K4_SERVING_3X3 with their forms, no check (``k4``
    checks): each conv's time, the class's total, and the build's registers. For
    comparing forms of the kernel built from copies of the package."""
    from ted_spad_tpu_torch.utils import cuda_build

    _, nvcc_out = cuda_build.build("int8conv")
    for name, r in cuda_build.ptxas_report(nvcc_out).items():
        if "bfloat16Lb1E" in name:  # the serving instantiations: bf16 compute, int8 out
            print(f"[K4 build] {name}: {r}", flush=True)
    calls = [(site, xs, ws, (1, 1), ((1, 1), (1, 1)), None, form)
             for site, xs, ws, form in K4_SERVING_3X3]
    rows = k4_timing(device, calls)
    total = {k: sum(r[k] for r in rows) for k in ("ms", "device_only_ms", "bound_ms")}
    print(f"[K4] class 2D 3x3: {len(rows)} convs, kernel {total['ms']:.3f} ms (device only "
          f"{total['device_only_ms']:.3f}), bound {total['bound_ms']:.3f} ms", flush=True)


def k4(device) -> None:
    import torch

    from ted_spad_tpu_torch.utils import cuda_build

    seconds, nvcc_out = cuda_build.build("int8conv")
    for name, r in cuda_build.ptxas_report(nvcc_out).items():
        print(f"[K4 build] {name}: {r}", flush=True)
    print(f"build {seconds:.2f}s", flush=True)
    print(f"{k4_check(device, K4_CASES)} elements bit-equal", flush=True)
    # The 79 convs of one int8 serving step, each alone at its shape with its form.
    step, batch = serving_int8_step(device)
    calls = record_int8_convs(step, batch)
    del step, batch
    torch.cuda.empty_cache()
    classes = k4_classes(k4_timing(device, calls))
    for name, agg in classes.items():
        print(f"[K4] class {name}: {agg['n']} convs, kernel {agg['ms']:.3f} ms (device only "
              f"{agg['device_only_ms']:.3f}), bound {agg['bound_ms']:.3f} ms "
              f"({agg['ms'] / agg['bound_ms']:.1f}x)", flush=True)
    total = {k: sum(a[k] for a in classes.values()) for k in ("ms", "device_only_ms", "bound_ms")}
    print(f"[K4] the {len(calls)} int8 convs of a step: kernel {total['ms']:.3f} ms (device only "
          f"{total['device_only_ms']:.3f}), bound {total['bound_ms']:.3f} ms", flush=True)


def device_profile(fn, steps: int = 3) -> dict:
    """Device time by kernel over ``steps`` calls of ``fn`` (torch.profiler, after one
    warm-up call): {"device_ms", "wall_ms", "busy", "kernels": [(name, ms)], "launches"},
    per call, the kernels sorted by time; ``launches`` counts the device-side events
    (kernels and copies) of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only (kernels, copies): a CPU op's device time repeats its kernels'.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    kernels = sorted(((e.key, e.self_device_time_total / steps / 1e3) for e in events),
                     key=lambda kv: -kv[1])
    device_ms = sum(ms for _, ms in kernels)
    return {"device_ms": device_ms, "wall_ms": wall_us / steps / 1e3,
            "busy": device_ms * steps * 1e3 / wall_us, "kernels": kernels,
            "launches": sum(e.count for e in events) / steps}


INT8_AB_URIS = [f"synthetic://n=320,h=240,w=320,seed={600 + i}" for i in range(4)]


def int8_step_turn(device, out_path: str) -> None:
    """One turn of ``int8ab``, run under whichever tree's package is on the path: the
    int8 serving step of chip_smoke.py's phase 11 (seeded UNet++ and I3Res50, scales
    calibrated on its videos' first two batches) on the first batch. Saves the step's
    output under deterministic cuDNN to ``out_path`` and prints one JSON line: the step's
    time (CUDA events), the bf16 step's beside it, and from the profiler the device time
    per step, K4's share of it and the top kernels."""
    import json

    import torch

    import ted_spad_tpu_torch.stages.feature_extraction as fe
    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
    from ted_spad_tpu_torch.ops.quant_unetpp import act_scales_from_absmax

    p = FeatureExtractionParams(batch_size=16, quant="int8", quant_calib_batches=2)
    fa, ft = load_fa_model(seed=0, device=device), load_ft_model(seed=0, device=device)
    # One decode worker: batches in the videos' order, the same in every process.
    batches = [torch.from_numpy(c).to(device) for c, _, _ in
               fe.iter_clip_batches(INT8_AB_URIS, p, p.batch_size, num_workers=1)][:2]
    calib = fe.make_fa_calibration_step(p, fa, ft, device=device)
    absmax: dict = {}
    # cuDNN's choice of algorithm would change the calibration's bf16 rounding, and with
    # it the scales, from one process to the next: calibrate and save deterministically.
    deterministic = torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                               deterministic=True, allow_tf32=False)
    with deterministic:
        for clips in batches:
            for k, v in calib(clips).items():
                absmax[k] = max(absmax.get(k, 0.0), float(v))
    step = fe.make_extract_step(ft, p, fa, device=device,
                                quant_act_scales=act_scales_from_absmax(absmax))
    bf16_step = fe.make_extract_step(ft, p.replace(quant="none"), fa, device=device)
    batch = batches[0]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        out = step(batch)
    torch.save(out.cpu(), out_path)
    prof = device_profile(lambda: step(batch))
    k4_ms = sum(ms for name, ms in prof["kernels"] if "int8_conv" in name)  # both K4 kernels
    print(json.dumps({"step_ms": time_ms(lambda: step(batch), reps=5, inner=2),
                      "bf16_step_ms": time_ms(lambda: bf16_step(batch), reps=5, inner=2),
                      "device_ms": prof["device_ms"], "busy": prof["busy"], "k4_device_ms": k4_ms,
                      "top": [(n[:80], round(ms, 3)) for n, ms in prof["kernels"][:12]]}),
          flush=True)


def _ab_turns(parent: str, turn: str, tag: str, headline) -> dict:
    """The turns parent / change / change / parent of the probe ``turn`` (it takes an
    output path, saves its output there and prints one JSON line starting '{"step_ms"'),
    each a process of its own under that tree's package and kernels (``parent``: another
    checkout, e.g. from git archive). Prints each turn's ``headline(reading)`` and top
    kernels; returns {"parent": [output, output], "change": [output, output]}."""
    import json
    import os
    import subprocess

    import torch

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"parent": os.path.abspath(parent), "change": here}
    outs = {}
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    for i, tree in enumerate(("parent", "change", "change", "parent")):
        out = os.path.join(here, "build", f"{tag}_{i}_{tree}.pt")
        code = ("import runpy, sys; probe, out, path = sys.argv[1:]; "
                "sys.argv = ['chip_probes', probe, out]; runpy.run_path(path, run_name='__main__')")
        proc = subprocess.run([sys.executable, "-c", code, turn, out, os.path.abspath(__file__)],
                              cwd=trees[tree], env={**os.environ, "PYTHONPATH": trees[tree]},
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"step_ms"')]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"{tag} turn {i} ({tree}) failed (exit {proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        reading = json.loads(lines[-1])
        outs.setdefault(tree, []).append(torch.load(out))
        print(f"[{tag}] turn {i} {tree}: {headline(reading)}", flush=True)
        for name, ms in reading["top"]:
            print(f"[{tag}]     {ms:8.3f} ms  {name}", flush=True)
    return outs


def int8ab(device, parent: str) -> None:
    """The int8 step of ``parent`` (a checkout of another commit, e.g. from git archive)
    and of this tree in turns (``_ab_turns`` of ``int8_step_turn``): the step's time and
    the bf16 step's, K4's device time per step, and whether the change's step output
    equals the parent's bit for bit under deterministic cuDNN."""
    import json

    import torch

    outs = _ab_turns(parent, "int8step", "int8ab", lambda r: (
        f"int8 step {r['step_ms']:.3f} ms, bf16 step {r['bf16_step_ms']:.3f} ms, device "
        f"{r['device_ms']:.3f} ms/step (busy {r['busy']:.3f}), K4 {r['k4_device_ms']:.3f} ms/step"))
    same = {"parent twice": torch.equal(*outs["parent"]), "change twice": torch.equal(*outs["change"]),
            "change vs parent": torch.equal(outs["change"][0], outs["parent"][0])}
    print(f"[int8ab] step outputs on the first batch, cuDNN deterministic: {json.dumps(same)}",
          flush=True)
    if not all(same.values()):
        d = float((outs["change"][0] - outs["parent"][0]).abs().max())
        raise AssertionError(f"int8ab: outputs differ (change vs parent max |d| {d})")


def _spread(x, ref) -> float:
    """||x - ref|| / ||ref - mean of ref over the batch||, in float64."""
    import torch

    x, ref = x.double(), ref.double()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref - ref.mean(0)))


def _timed(tag: str, fn, ref=None, top: int = 3) -> float:
    """Print one piece's time (CUDA events), its profiler's top kernels and, with
    ``ref``, its output's error over the batch spread against ``ref``."""
    out = fn()
    ms = time_ms(fn, reps=5, inner=2)
    prof = device_profile(fn, steps=2)
    err = "" if ref is None else f", error / spread vs the module form {_spread(out, ref):.6f}"
    print(f"[fast] {tag}: {ms:.3f} ms (device {prof['device_ms']:.3f} ms, busy {prof['busy']:.3f})"
          f"{err}", flush=True)
    for name, kms in prof["kernels"][:top]:
        print(f"[fast]     {kms:8.3f} ms  {name[:100]}", flush=True)
    return ms


def fastforms(device) -> None:
    """See the module docstring."""
    import torch

    import ted_spad_tpu_torch.stages.feature_extraction as fe
    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
    from ted_spad_tpu_torch.ops import fast_i3d, fast_unetpp

    p = FeatureExtractionParams(batch_size=16)
    fa, ft = load_fa_model(seed=0, device=device), load_ft_model(seed=0, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    n, t = p.batch_size, p.num_frames
    frames = torch.rand((n * t, 224, 224, 3), generator=g, device=device).to(torch.bfloat16)
    x = frames.permute(0, 3, 1, 2)

    with torch.inference_mode():
        ref = fa(x)
        _timed("UNet++ module, 256 frames", lambda: fa(x), top=6)
        for stem in ("plain", "s2d"):
            _timed(f"UNet++ fused form, stem {stem}", lambda: fast_unetpp.fast_unetpp_apply(
                fa, frames, stem_mode=stem).movedim(-1, 1), ref, top=8)
        s2d_ref = fast_i3d.space_to_depth_2x2(ref.to(torch.bfloat16), channel_dim=1)
        _timed("UNet++ fused form, emit_s2d", lambda: fast_unetpp.fast_unetpp_apply(
            fa, frames, emit_s2d=True).movedim(-1, 1), s2d_ref)

        clips = torch.rand((n, t, 224, 224, 3), generator=g, device=device).to(torch.bfloat16)
        c = clips.permute(0, 4, 1, 2, 3)
        stem_ref = ft.i3d.stem(c)
        _timed("I3Res50 stem, module ConvBN", lambda: ft.i3d.stem(c))
        xs = fast_i3d.space_to_depth_2x2(c, channel_dim=1)
        _timed("s2d relayout of the clips", lambda: fast_i3d.space_to_depth_2x2(c, channel_dim=1))
        _timed("I3Res50 s2d stem", lambda: fast_i3d.s2d_stem(ft.i3d.stem, xs, torch.bfloat16),
               stem_ref)

    # Clips of synthetic videos: random pixels give every clip the same features, and the
    # error over the spread between clips would read noise.
    batch = torch.from_numpy(next(fe.iter_clip_batches(STEP_AB_URIS, p, n, num_workers=1))[0]).to(device)
    fa32 = load_fa_model(seed=0, dtype="float32", device=device)
    ft32 = load_ft_model(seed=0, dtype="float32", device=device)
    ref32 = fe.make_extract_step(ft32, p.replace(compute_dtype="float32"), fa32, use_kernel=False,
                                 device=device, fast_forms=False)(batch)
    del fa32, ft32
    print("[fast] the steps below against the float32 module step (plain preprocess, TF32 off)")
    module = fe.make_extract_step(ft, p, fa, device=device, fast_forms=False)
    _timed("extraction step, module forms", lambda: module(batch), ref32, top=8)
    step = fe.make_extract_step(ft, p, fa, device=device)
    _timed("extraction step, fast forms (bridged)", lambda: step(batch), ref32, top=10)


STEP_AB_URIS = [f"synthetic://n=320,h=240,w=320,seed={700 + i}" for i in range(2)]


def step_turn(device, out_path: str) -> None:
    """One turn of ``stepab`` under whichever tree's package is on the path: the default
    16-clip UNet++ serving step on the first batch of STEP_AB_URIS; saves its features to
    ``out_path`` and prints one JSON line (step time, device time, busy share, top
    kernels)."""
    import json

    import torch

    import ted_spad_tpu_torch.stages.feature_extraction as fe
    from ted_spad_tpu_torch.config.params import FeatureExtractionParams
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model

    p = FeatureExtractionParams(batch_size=16)
    fa, ft = load_fa_model(seed=0, device=device), load_ft_model(seed=0, device=device)
    clips, _, _ = next(fe.iter_clip_batches(STEP_AB_URIS, p, p.batch_size, num_workers=1))
    batch = torch.from_numpy(clips).to(device)
    step = fe.make_extract_step(ft, p, fa, device=device)
    torch.save(step(batch).cpu(), out_path)
    prof = device_profile(lambda: step(batch))
    print(json.dumps({"step_ms": time_ms(lambda: step(batch), reps=5, inner=2),
                      "device_ms": prof["device_ms"], "busy": prof["busy"],
                      "top": [(n[:80], round(ms, 3)) for n, ms in prof["kernels"][:10]]}),
          flush=True)


def stepab(device, parent: str) -> None:
    """See the module docstring."""
    import json

    outs = _ab_turns(parent, "stepturn", "stepab", lambda r: (
        f"step {r['step_ms']:.3f} ms, device {r['device_ms']:.3f} ms/step (busy {r['busy']:.3f})"))
    errs = {"parent twice": _spread(outs["parent"][1], outs["parent"][0]),
            "change twice": _spread(outs["change"][1], outs["change"][0]),
            "change vs parent": _spread(outs["change"][0], outs["parent"][0])}
    print(f"[stepab] features on the first batch, error / between-clip spread: {json.dumps(errs)}",
          flush=True)


@contextlib.contextmanager
def module_train_forms():
    """The module side of the train-form A/B: inside the block the training stages run
    their models' train forwards through the modules (``make_fast_fa_apply`` as the
    stages call it runs the module when ``train`` is set and its eval form otherwise;
    ``make_fast_ft_train_forward`` gives ``fast_i3d.module_train_forward``). A stage's
    step built inside the block keeps the module forms."""
    from ted_spad_tpu_torch.ops import fast_i3d, fast_unetpp
    from ted_spad_tpu_torch.stages import action_training, anonymization_training, fa_pretraining

    def fa_apply(fa):
        fast = fast_unetpp.make_fast_fa_apply(fa)

        def apply(frames, train=False, **kw):
            return fa(frames, train=True, **kw) if train else fast(frames, **kw)

        apply.supports_s2d = fast.supports_s2d
        return apply

    patches = [(fa_pretraining, "make_fast_fa_apply", fa_apply),
               (anonymization_training, "make_fast_fa_apply", fa_apply),
               (anonymization_training, "make_fast_ft_train_forward", fast_i3d.module_train_forward),
               (action_training, "make_fast_ft_train_forward", fast_i3d.module_train_forward)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# The calls counted around the training steps (``counted``): the fa's train form, the
# I3Res50 train form's s2d stem conv, the eval form's folded s2d stem, and the fused
# cuDNN conv + ReLU calls, which have no backward: none of those may run while grad mode
# is on.
COUNTED_CALLS = (("ted_spad_tpu_torch.ops.fast_unetpp", "fast_unetpp_train_apply"),
                 ("ted_spad_tpu_torch.ops.fast_i3d", "s2d_stem_conv"),
                 ("ted_spad_tpu_torch.ops.fast_i3d", "s2d_stem"),
                 ("torch", "cudnn_convolution_relu"),
                 ("torch", "cudnn_convolution_add_relu"))
FUSED_CALLS = ("cudnn_convolution_relu", "cudnn_convolution_add_relu")


@contextlib.contextmanager
def counted(calls: dict):
    """Count the calls of each of COUNTED_CALLS inside the block into ``calls``, keyed
    ``name`` or ``name (grad)`` by whether grad mode was on."""
    import importlib

    import torch

    saved = []
    for mod_name, name in COUNTED_CALLS:
        mod = importlib.import_module(mod_name)
        real = getattr(mod, name)

        def counting(*a, _name=name, _real=real, **k):
            key = f"{_name} (grad)" if torch.is_grad_enabled() else _name
            calls[key] = calls.get(key, 0) + 1
            return _real(*a, **k)

        saved.append((mod, name, real))
        setattr(mod, name, counting)
    try:
        yield calls
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def fused_under_grad(calls: dict) -> int:
    return sum(calls.get(f"{n} (grad)", 0) for n in FUSED_CALLS)


def check_train_form(calls: dict, key: str, form: str, what: str, n: int | None = None) -> None:
    """A step's counted calls (``counted``): the train form called ``key`` under grad
    ``n`` times (at least once where ``n`` is None), the module form never, and neither
    reached a fused cuDNN call under grad."""
    got = calls.get(f"{key} (grad)", 0)
    want = 0 if form == "module form" else n
    if got == 0 if want is None else got != want:
        raise AssertionError(f"{what}, {form}: {key} under grad {got} times (expected "
                             f"{'at least 1' if want is None else want})")
    if fused_under_grad(calls):
        raise AssertionError(f"{what}, {form}: a fused cuDNN call (no backward) ran under grad: "
                             f"{calls}")


TRAINAB_STEPS = 4
TRAINAB_TURNS = ("train form", "module form", "module form", "train form") * 2


def train_steps(device) -> dict:
    """{name: (make_step, run, key)} of ``trainab``'s steps: ``make_step()`` builds the
    stage's step (under ``module_train_forms`` it keeps the module forms), ``run(step)``
    runs one on fixed seeded inputs, ``key`` is the call its train form makes under grad
    (``check_train_form``)."""
    import numpy as np
    import torch

    from ted_spad_tpu_torch.config.params import (
        ActionParams, AnonymizationParams, ReconstructionParams,
    )
    from ted_spad_tpu_torch.data.images import sample_image_augment_params
    from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model
    from ted_spad_tpu_torch.ops.augment import sample_augment_params
    from ted_spad_tpu_torch.stages import action_training, fa_pretraining
    from ted_spad_tpu_torch.stages import anonymization_training as anon
    from ted_spad_tpu_torch.stages.common import make_optimizer

    rng = np.random.default_rng(0)
    kw = dict(seed=0, dtype="float32", device=device)
    rp, ap, p = ReconstructionParams(), ActionParams(temporal_loss="trip"), AnonymizationParams()
    fa = load_fa_model(rp.arch_fa, **kw).requires_grad_(True)
    images = torch.from_numpy(rng.integers(0, 256, (rp.batch_size, 256, 256, 3), dtype=np.uint8)).to(device)
    image_draw = sample_image_augment_params(rng, rp.batch_size, 256, rp.reso_h, rp.reso_w)
    ft = load_ft_model(ap.arch, num_classes=ap.num_classes, dropout_rate=ap.ft_dropout or None,
                       **kw).requires_grad_(True)
    gen = torch.Generator(device=device).manual_seed(0)
    b = ap.batch_size
    clips = torch.from_numpy(rng.integers(0, 256, (b, 3, ap.num_frames, 240, 320, 3), dtype=np.uint8)).to(device)
    labels = rng.integers(0, ap.num_classes, b)
    clip_draw = sample_augment_params(rng, b * 3, 240, 320, ap.reso_h, ap.reso_w)
    fa_key, ft_key = "fast_unetpp_train_apply", "s2d_stem_conv"
    steps = {
        "fa pretraining step (UNet++, 32 x 224^2)": (
            lambda: fa_pretraining.make_train_step(
                fa, make_optimizer(fa.parameters(), "adam", rp.learning_rate), (rp.reso_h, rp.reso_w),
                compute_dtype=rp.compute_dtype, device=device),
            lambda step: step(images, image_draw), fa_key),
        "action step (I3Res50 + head, 16 videos x 3 views of 16 x 224^2, FrozenBN)": (
            lambda: action_training.make_train_step(
                ft, make_optimizer(ft.parameters(), ap.opt_type, ap.learning_rate, ap.weight_decay,
                                   ap.momentum), ap, generator=gen, device=device),
            lambda step: step(clips, labels, clip_draw), ft_key),
    }
    adv_fa = load_fa_model(p.arch_fa, **kw).requires_grad_(True)
    fb = load_fb_model(ssl=True, **kw).requires_grad_(True)
    adv_ft = load_ft_model(p.arch_ft, num_classes=p.num_classes, **kw).requires_grad_(True)
    g = torch.Generator(device=device).manual_seed(1)
    side = (p.reso_h, p.reso_w, 3)
    v1, v2 = (torch.rand((p.batch_size_vispr,) + side, generator=g, device=device) for _ in range(2))
    adv_clips = torch.rand((p.batch_size, 3, p.num_frames) + side, generator=g, device=device)
    adv_labels = torch.from_numpy(rng.integers(0, p.num_classes, p.batch_size)).to(device)
    opts = [make_optimizer(m.parameters(), p.opt_type, lr, p.weight_decay)
            for m, lr in ((adv_fa, p.learning_rate_fa), (fb, p.learning_rate_fb), (adv_ft, p.learning_rate_ft))]

    def adv(step):
        return step(v1, v2, adv_clips, adv_labels)

    for remat in ("auto", "blocks", "off"):
        q = p.replace(remat=remat)
        steps[f"adversarial fa step (8 videos x 3 views + 12 pairs, remat {remat!r})"] = (
            lambda q=q: anon.make_fa_step(adv_fa, fb, adv_ft, opts[0], q, device=device), adv, fa_key)
        steps[f"adversarial fb/ft step (8 videos x 3 views + 12 pairs, remat {remat!r})"] = (
            lambda q=q: anon.make_fbft_step(adv_fa, fb, adv_ft, opts[1], opts[2], q, generator=gen,
                                            device=device), adv, ft_key)
    return steps


def train_turn(device, make_step, run, n: int = TRAINAB_STEPS, warmup: int = 1,
               profile: bool = True) -> dict:
    """One turn of ``train_ab``: the step built, ``warmup`` steps, ``n`` steps timed
    (CUDA events), then with ``profile`` one step profiled: {"ms": [...], "peak_mib", and
    with ``profile`` "device_ms", "busy", "launches"}."""
    import torch

    torch.cuda.reset_peak_memory_stats(device)
    step = make_step()
    for _ in range(warmup):
        run(step)
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(step)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    out = {"ms": times, "peak_mib": torch.cuda.max_memory_allocated(device) / 2**20}
    if profile:
        prof = device_profile(lambda: run(step), steps=1)
        out.update(device_ms=prof["device_ms"], busy=prof["busy"], launches=prof["launches"])
    return out


def train_ab(device, make_step, run, key: str, what: str, turns=TRAINAB_TURNS,
             n: int = TRAINAB_STEPS, warmup: int = 2, profile: bool = True) -> dict:
    """One step with the train forms against the module forms: a discarded turn of
    ``turns[0]`` (the first turn on a step pays the process's first work on it), then
    each of ``turns`` (``train_turn``), the module form's inside ``module_train_forms``,
    each counted (``counted``) and checked (``check_train_form``: the train form called
    ``key`` under grad, the module form did not, no fused cuDNN call under grad).
    {form: [train_turn's reading with its "calls"]}."""
    import torch

    out = {"train form": [], "module form": []}
    for i, form in enumerate((turns[0],) + tuple(turns)):
        with module_train_forms() if form == "module form" else contextlib.nullcontext(), \
                counted({}) as calls:
            r = train_turn(device, make_step, run, n, warmup, profile=profile and i > 0)
        check_train_form(calls, key, form, what)
        torch.cuda.empty_cache()
        if i:
            out[form].append(dict(r, calls=calls))
    return out


def ab_summary(ab: dict) -> str:
    """``train_ab``'s readings in one line: each form's median step over its turns, the
    turns' medians, peak memory (and device time and busy share where profiled), the
    ratio of the medians."""
    import statistics

    parts, medians = [], {}
    for form, rs in ab.items():
        medians[form] = statistics.median(x for r in rs for x in r["ms"])
        turns = " / ".join(f"{statistics.median(r['ms']):.3f}" for r in rs)
        device = (f", device {statistics.mean(r['device_ms'] for r in rs):.3f} ms/step, busy "
                  f"{statistics.mean(r['busy'] for r in rs):.3f}" if "device_ms" in rs[0] else "")
        parts.append(f"{form} median {medians[form]:.3f} ms (turns' medians {turns}), peak "
                     f"{max(r['peak_mib'] for r in rs):.1f} MiB{device}")
    parts.append(f"module / train form {medians['module form'] / medians['train form']:.3f}")
    return "; ".join(parts)


def trainab(device) -> None:
    """See the module docstring."""
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[trainab] {card}", flush=True)
    for name, (make_step, run, key) in train_steps(device).items():
        ab = train_ab(device, make_step, run, key, name)
        for form, rs in ab.items():
            for r in rs:
                print(f"[trainab] {name}, {form}: steps {[round(x, 3) for x in r['ms']]} ms, peak "
                      f"{r['peak_mib']:.1f} MiB, device {r['device_ms']:.3f} ms/step, busy "
                      f"{r['busy']:.3f}, {r['launches']:.0f} device events a step", flush=True)
        print(f"[trainab] {name}: {ab_summary(ab)}", flush=True)


# ---------------------------------------------------------------------------
# k5, k6: the deterministic backward kernels of the training paths
# ---------------------------------------------------------------------------

# Checks beside the shapes a training run records: (name, input (B, C, D, H, W), window,
# strides, padding). Each runs in float32, bf16 and float64, NCDHW and channels_last_3d,
# with planted ties (small integers: most windows hold several maxima) and without.
# The edges of K5's mappings (ops/maxpool3d.py: k5_plan; channels_last_3d runs the owner
# form, NCDHW the row form): C one 16-byte vector of bf16 (two of float32, four of
# float64), two bf16 vectors, ragged C (one-element stores); a stride-1 (3,3,3) pool whose
# windows clip at every face; a width-1 row; a row cut into column runs or chunks with a
# remainder; a stride no row-form instance compiles in (runtime division); more channels
# than a chunk (two chunks, the second partial) and than the row form's lanes (its loop).
K5_CASES = (
    ("ragged", (3, 5, 7, 9, 11), (2, 3, 3), (2, 2, 2), (0, 0, 0)),
    ("ragged stride 1", (2, 3, 6, 7, 5), (3, 3, 3), (1, 1, 1), (0, 0, 0)),
    ("MViT skip padding", (2, 4, 3, 9, 7), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("padded on every axis", (1, 3, 5, 6, 7), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ("I3Res50 stem, 2 clips", (2, 64, 8, 112, 112), (2, 3, 3), (2, 2, 2), (0, 0, 0)),
    ("one vector", (2, 8, 4, 9, 10), (2, 3, 3), (2, 2, 2), (0, 0, 0)),
    ("two vectors, stride 1 at every face", (2, 16, 5, 7, 9), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("ragged channels", (2, 19, 4, 7, 6), (2, 3, 3), (2, 2, 2), (0, 0, 0)),
    ("width 1", (2, 8, 4, 6, 1), (2, 2, 1), (2, 2, 1), (0, 0, 0)),
    ("row split with a remainder", (1, 8, 2, 3, 301), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("runtime stride 3", (1, 8, 3, 10, 11), (1, 3, 3), (1, 3, 3), (0, 0, 0)),
    ("lane loop", (1, 2064, 2, 3, 4), (2, 3, 3), (2, 2, 2), (0, 0, 0)),
)
# The adversarial steps' stem pool at AnonymizationParams' defaults (8 videos x 3 views,
# 16 x 224^2 -> the stem's 64 x 8 x 112^2), bf16, channels_last_3d as the ft runs it.
K5_TIMED = ((24, 64, 8, 112, 112), (2, 3, 3), (2, 2, 2), (0, 0, 0))
# (name, input (N, C, H, W)), each in float32 and float64, NCHW and channels_last; the
# edges of K6's mapping (ops/upsample.py: k6_plan): C one float32 vector (two float64),
# ragged C, a last band shorter than K6_BAND, a width-1 column, more channel vectors than
# a block's threads (the lane loop).
K6_CASES = (("ragged", (2, 3, 5, 7)), ("one pixel", (1, 4, 1, 1)), ("one row", (2, 3, 1, 9)),
            ("odd", (1, 16, 13, 17)), ("UNet up1, 2 frames", (2, 512, 14, 14)),
            ("one vector", (2, 4, 9, 11)), ("ragged channels", (2, 6, 5, 7)),
            ("band remainder", (1, 8, 37, 13)), ("width 1", (2, 8, 6, 1)), ("lane loop", (1, 1032, 3, 5)))
# The UNet's largest upsample (up4: 64 channels, 112^2 -> 224^2) on the fa pretraining
# batch of 32 frames, float32, channels_last as the UNet runs it.
K6_TIMED = (32, 64, 112, 112)


def k5_operands(device, shape, window, strides, padding, dtype, channels_last: bool, ties: bool,
                seed: int = 0, grad_stride=None):
    """(grad_out, indices) of a max pool over a seeded input of ``shape`` in ``dtype``:
    small integers with ``ties``, else normal values; grad_out normal values, laid out
    as the pool's output or with ``grad_stride``."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randint(-2, 3, shape, generator=g, device=device) if ties
         else torch.randn(shape, generator=g, device=device)).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last_3d)
    out, indices = F.max_pool3d(x, window, strides, padding, return_indices=True)
    values = torch.randn(out.shape, generator=g, device=device).to(dtype)
    grad = (torch.empty_like(out) if grad_stride is None
            else torch.empty_strided(out.shape, grad_stride, dtype=dtype, device=device))
    return grad.copy_(values), indices


def _bit_error(got, ref, fmt) -> float:
    """max |got - ref|, 0.0 exactly where the two are bit-equal; raises where ``got`` is
    not in the layout ``fmt``."""
    import torch

    if not got.is_contiguous(memory_format=fmt):
        raise AssertionError(f"the kernel's gradient is not in {fmt}: strides {got.stride()}")
    return 0.0 if torch.equal(got, ref) else float((got.double() - ref.double()).abs().max())


def k5_error(grad, indices, shape, window, strides, padding, channels_last: bool) -> float:
    """K5 against its plain version on these operands (``_bit_error``)."""
    import torch

    from ted_spad_tpu_torch.ops.maxpool3d import max_pool3d_backward, max_pool3d_backward_reference

    got = max_pool3d_backward(grad, indices, shape, window, strides, padding, channels_last)
    ref = max_pool3d_backward_reference(grad, indices, shape, window, strides, padding, channels_last)
    return _bit_error(got, ref, torch.channels_last_3d if channels_last else torch.contiguous_format)


def k6_operands(device, shape, dtype, channels_last: bool, seed: int = 0, grad_stride=None):
    """grad_out of the x2 upsample of ``shape``: seeded normal values in ``dtype``,
    NCHW, channels_last, or laid out with ``grad_stride``."""
    import torch

    n, c, h, w = shape
    out = (n, c, 2 * h, 2 * w)
    values = torch.randn(out, generator=torch.Generator(device=device).manual_seed(seed), device=device)
    if grad_stride is not None:
        grad = torch.empty_strided(out, grad_stride, dtype=dtype, device=device)
    else:
        grad = torch.empty(out, dtype=dtype, device=device,
                           memory_format=torch.channels_last if channels_last else torch.contiguous_format)
    return grad.copy_(values)


def k6_error(grad, shape, channels_last: bool) -> float:
    """K6 against its plain version on these operands (``_bit_error``)."""
    import torch

    from ted_spad_tpu_torch.ops.upsample import (
        upsample_bilinear_backward, upsample_bilinear_backward_reference,
    )

    got = upsample_bilinear_backward(grad, shape, channels_last)
    ref = upsample_bilinear_backward_reference(grad, shape, channels_last)
    return _bit_error(got, ref, torch.channels_last if channels_last else torch.contiguous_format)


def k5_check(device, log=print) -> tuple[int, float]:
    """K5 bit-equal to its plain version at every K5_CASES shape, dtype, layout and tie
    pattern; raises on the first that is not. Returns (checks, worst max |error|)."""
    import torch

    n, worst = 0, 0.0
    for i, (name, shape, window, strides, padding) in enumerate(K5_CASES):
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            for cl in (False, True):
                for ties in (True, False):
                    ops = k5_operands(device, shape, window, strides, padding, dtype, cl, ties, seed=i)
                    err = k5_error(*ops, shape, window, strides, padding, cl)
                    if err != 0.0:
                        raise AssertionError(f"K5 differs from its plain version at {name} {shape} "
                                             f"{dtype} channels_last={cl} ties={ties}: {err}")
                    n, worst = n + 1, max(worst, err)
    log(f"[K5] bit-equal to its plain version at {n} checks: {len(K5_CASES)} shapes "
        f"({', '.join(c[0] for c in K5_CASES)}) x float32 / bf16 / float64 x NCDHW / channels_last_3d "
        f"x planted ties / none")
    return n, worst


def k6_check(device, log=print) -> tuple[int, float]:
    """K6 bit-equal to its plain version at every K6_CASES shape, dtype and layout;
    raises on the first that is not. Returns (checks, worst max |error|)."""
    import torch

    n, worst = 0, 0.0
    for i, (name, shape) in enumerate(K6_CASES):
        for dtype in (torch.float32, torch.float64):
            for cl in (False, True):
                err = k6_error(k6_operands(device, shape, dtype, cl, seed=i), shape, cl)
                if err != 0.0:
                    raise AssertionError(f"K6 differs from its plain version at {name} {shape} {dtype} "
                                         f"channels_last={cl}: {err}")
                n, worst = n + 1, max(worst, err)
    log(f"[K6] bit-equal to its plain version at {n} checks: {len(K6_CASES)} shapes "
        f"({', '.join(c[0] for c in K6_CASES)}) x float32 / float64 x NCHW / channels_last")
    return n, worst


@contextlib.contextmanager
def recorded_backward_calls(seen: dict):
    """Record every call of K5's and K6's wrappers inside the block into ``seen``
    ({key: calls}; key ("K5", input shape, window, strides, padding, dtype name,
    channels_last, grad_out's strides) or ("K6", input shape, dtype name, channels_last,
    grad_out's strides)). The recording wrappers take the wrappers'
    names in their modules, so their launch counts go on as before."""
    from ted_spad_tpu_torch.ops import maxpool3d, upsample

    real5, real6 = maxpool3d.max_pool3d_backward, upsample.upsample_bilinear_backward

    def k5(grad_out, indices, input_shape, window, strides, padding=(0, 0, 0), channels_last=False):
        key = ("K5", tuple(input_shape), tuple(window), tuple(strides), tuple(padding),
               str(grad_out.dtype).replace("torch.", ""), bool(channels_last), tuple(grad_out.stride()))
        seen[key] = seen.get(key, 0) + 1
        return real5(grad_out, indices, input_shape, window, strides, padding, channels_last)

    def k6(grad_out, input_shape, channels_last=False):
        key = ("K6", tuple(input_shape), str(grad_out.dtype).replace("torch.", ""),
               bool(channels_last), tuple(grad_out.stride()))
        seen[key] = seen.get(key, 0) + 1
        return real6(grad_out, input_shape, channels_last)

    # The real wrappers count through their module names: the counts move with them.
    k5.launches, k6.launches = real5.launches, real6.launches
    maxpool3d.max_pool3d_backward, upsample.upsample_bilinear_backward = k5, k6
    try:
        yield seen
    finally:
        real5.launches, real6.launches = k5.launches, k6.launches
        maxpool3d.max_pool3d_backward, upsample.upsample_bilinear_backward = real5, real6


def check_recorded(device, seen: dict, log=print) -> dict:
    """K5 and K6 against their plain versions at every recorded call
    (``recorded_backward_calls``): its shape, dtype, layout and grad_out's strides as
    recorded, so the plan (K5's form, its tiles and chunks; K6's band and chunks) is the
    training path's; raises on the first that is not bit-equal. Returns {"K5": (checks,
    worst max |error|), "K6": likewise}."""
    import torch

    n, worst = {"K5": 0, "K6": 0}, {"K5": 0.0, "K6": 0.0}
    for i, key in enumerate(sorted(seen, key=str)):
        if key[0] == "K5":
            _, shape, window, strides, padding, dtype, cl, stride = key
            for ties in (True, False):
                ops = k5_operands(device, shape, window, strides, padding, getattr(torch, dtype), cl, ties,
                                  seed=i, grad_stride=stride)
                err = k5_error(*ops, shape, window, strides, padding, cl)
                if err != 0.0:
                    raise AssertionError(f"K5 differs from its plain version at the recorded call {key}: "
                                         f"{err}")
        else:
            _, shape, dtype, cl, stride = key
            err = k6_error(k6_operands(device, shape, getattr(torch, dtype), cl, seed=i, grad_stride=stride),
                           shape, cl)
            if err != 0.0:
                raise AssertionError(f"K6 differs from its plain version at the recorded call {key}: {err}")
        n[key[0]] += 1
        worst[key[0]] = max(worst[key[0]], err)
        log(f"[{key[0]}] recorded call {key[1:]} ({seen[key]} calls): bit-equal to its plain version")
    return {k: (n[k], worst[k]) for k in n}


def k5_times(device, shape, window, strides, padding, dtype, channels_last: bool, grad_stride=None,
             plain: bool = False) -> dict:
    """K5 at one call (operands as ``k5_operands`` makes them, without ties), held bit-equal
    to its plain version on the timed operands (raises where not), timed (``time_ms``, and
    device only with ``queued``) beside torch's own atomic backward (the library
    yardstick, which the port never calls), the byte bound (grad_out, the int64 indices
    and grad_in each moved once) and, with ``plain``, the plain version; the plan where
    the package has one (``k5_plan``)."""
    import math

    import torch

    from ted_spad_tpu_torch.ops import maxpool3d

    grad, idx = k5_operands(device, shape, window, strides, padding, dtype, channels_last, ties=False,
                            grad_stride=grad_stride)
    args = (grad, idx, shape, window, strides, padding, channels_last)
    err = k5_error(*args)
    if err != 0.0:
        raise AssertionError(f"K5 differs from its plain version at the timed {shape} {dtype}: {err}")
    x = torch.empty(shape, dtype=dtype, device=device,
                    memory_format=torch.channels_last_3d if channels_last else torch.contiguous_format)
    kernel = lambda: maxpool3d.max_pool3d_backward(*args)  # noqa: E731
    library = lambda: torch.ops.aten.max_pool3d_with_indices_backward(  # noqa: E731
        grad, x, window, strides, padding, (1, 1, 1), False, idx)
    ms, library_ms = time_ms(kernel, reps=10, inner=4), time_ms(library, reps=10, inner=4)
    device_ms = time_ms(kernel, reps=10, inner=4, queued=True)
    library_device_ms = time_ms(library, reps=10, inner=4, queued=True)
    moved = grad.numel() * grad.element_size() + idx.numel() * 8 + math.prod(shape) * grad.element_size()
    plan = getattr(maxpool3d, "k5_plan", None)
    out = {"shape": list(shape), "ms": ms, "library_ms": library_ms, "device_ms": device_ms,
           "library_device_ms": library_device_ms, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "moved_mb": moved / 1e6,
           "plan": str(tuple(plan(grad, idx, shape, window, strides, channels_last))) if plan else "none"}
    if plain:
        out["plain_ms"] = time_ms(lambda: maxpool3d.max_pool3d_backward_reference(*args), reps=3, inner=1)
    return out


def k6_times(device, shape, dtype, channels_last: bool, grad_stride=None, plain: bool = False) -> dict:
    """K6 at one call (operands as ``k6_operands`` makes them), held bit-equal to its
    plain version on the timed operands (raises where not), timed (``time_ms``, and
    device only with ``queued``) beside torch's own atomic backward (the library
    yardstick, which the port never calls), the byte bound (grad_out and grad_in each
    moved once) and, with ``plain``, the plain version; the plan where the package has
    one (``k6_plan``)."""
    import math

    import torch

    from ted_spad_tpu_torch.ops import upsample

    grad = k6_operands(device, shape, dtype, channels_last, grad_stride=grad_stride)
    err = k6_error(grad, shape, channels_last)
    if err != 0.0:
        raise AssertionError(f"K6 differs from its plain version at the timed {shape} {dtype}: {err}")
    kernel = lambda: upsample.upsample_bilinear_backward(grad, shape, channels_last)  # noqa: E731
    library = lambda: torch.ops.aten.upsample_bilinear2d_backward(  # noqa: E731
        grad, list(grad.shape[2:]), list(shape), True, None, None)
    ms, library_ms = time_ms(kernel, reps=10, inner=4), time_ms(library, reps=10, inner=4)
    device_ms = time_ms(kernel, reps=10, inner=4, queued=True)
    library_device_ms = time_ms(library, reps=10, inner=4, queued=True)
    moved = (grad.numel() + math.prod(shape)) * grad.element_size()
    plan = getattr(upsample, "k6_plan", None)
    out = {"shape": list(shape), "ms": ms, "library_ms": library_ms, "device_ms": device_ms,
           "library_device_ms": library_device_ms, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "moved_mb": moved / 1e6,
           "plan": str(tuple(plan(grad, shape, channels_last))) if plan else "none"}
    if plain:
        out["plain_ms"] = time_ms(lambda: upsample.upsample_bilinear_backward_reference(grad, shape, channels_last),
                                  reps=3, inner=1)
    return out


def times_line(t: dict) -> str:
    """``k5_times`` / ``k6_times``' reading in one line."""
    plain = f", plain {t['plain_ms']:.4f} ms" if "plain_ms" in t else ""
    return (f"kernel {t['ms']:.4f} ms (device only {t['device_ms']:.4f}, {t['moved_mb'] / t['device_ms']:.1f} "
            f"GB/s){plain}, torch's atomic backward {t['library_ms']:.4f} ms (device only "
            f"{t['library_device_ms']:.4f}), bound {t['bound_ms']:.4f} ms (bytes: {t['moved_mb']:.1f} MB), "
            f"device only {t['device_ms'] / t['bound_ms']:.2f}x the bound and "
            f"{t['device_ms'] / t['library_device_ms']:.2f}x torch's; plan {t['plan']}")


def k5_timing(device, log=print) -> dict:
    """K5 at K5_TIMED (bf16, channels_last_3d): ``k5_times`` with the plain version."""
    import torch

    t = k5_times(device, *K5_TIMED, torch.bfloat16, True, plain=True)
    shape, window, strides, _ = K5_TIMED
    log(f"[K5] stem pool {shape} {window}/{strides} bf16 channels_last_3d: {times_line(t)}")
    return t


def k6_timing(device, log=print) -> dict:
    """K6 at K6_TIMED (float32, channels_last): ``k6_times`` with the plain version."""
    import torch

    t = k6_times(device, K6_TIMED, torch.float32, True, plain=True)
    log(f"[K6] UNet up4 {K6_TIMED} x2 float32 channels_last: {times_line(t)}")
    return t


def time_recorded(device, seen: dict, log=print) -> list[dict]:
    """K5 and K6 timed at every recorded call (``recorded_backward_calls``) with its
    shape, dtype, layout and grad_out's strides (``k5_times`` / ``k6_times``, each held
    bit-equal on its timed operands): one line a call, and the readings, each with its key."""
    import torch

    rows = []
    for key in sorted(seen, key=str):
        if key[0] == "K5":
            _, shape, window, strides, padding, dtype, cl, stride = key
            t = k5_times(device, shape, window, strides, padding, getattr(torch, dtype), cl, grad_stride=stride)
        else:
            _, shape, dtype, cl, stride = key
            t = k6_times(device, shape, getattr(torch, dtype), cl, grad_stride=stride)
        log(f"[{key[0]}] timed recorded call {key[1:]}: {times_line(t)}")
        rows.append({"key": [str(k) for k in key], **t})
    return rows


def backward_register_report(name: str, log=print) -> dict[str, dict[str, int]]:
    """Build ``csrc/<name>.cu`` and print each instantiation's registers and spills;
    raises where one spills."""
    from ted_spad_tpu_torch.utils.cuda_build import build, ptxas_report

    seconds, out = build(name)
    report = ptxas_report(out)
    for kernel, r in report.items():
        log(f"[build] {name}: {kernel}: {r['registers']} registers, spills {r['spill_stores']} / "
            f"{r['spill_loads']} bytes")
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"{name}: {kernel} spills")
    log(f"[build] csrc/{name}.cu built in {seconds:.2f}s")
    return report


def k5(device) -> None:
    """See the module docstring."""
    backward_register_report("maxpool3d")
    k5_check(device)
    k5_timing(device)


def k6(device) -> None:
    """See the module docstring."""
    backward_register_report("upsample_bilinear")
    k6_check(device)
    k6_timing(device)


# k5ab / k6ab's shapes beside K5_TIMED / K6_TIMED, calls phase 19 records on the
# adversarial steps (24 clips): (input shape, window, strides, padding, dtype name,
# channels_last): InceptionI3d's 2a (1,3,3)/(1,2,2) and (3,3,3)/(1,1,1) branch pools, the
# I3Res50's layer1 pool, InceptionI3d's 5a; (input shape, dtype name, channels_last):
# the plain UNet's up1 at 32 frames and up2 at 4.
K5_AB = (((24, 64, 8, 113, 113), (1, 3, 3), (1, 2, 2), (0, 0, 0), "bfloat16", True),
         ((24, 192, 10, 30, 30), (3, 3, 3), (1, 1, 1), (0, 0, 0), "bfloat16", True),
         ((24, 256, 4, 55, 55), (2, 1, 1), (2, 1, 1), (0, 0, 0), "bfloat16", True),
         ((24, 832, 4, 14, 14), (2, 2, 2), (2, 2, 2), (0, 0, 0), "bfloat16", True))
K6_AB = (((32, 512, 14, 14), "float32", True), ((4, 256, 28, 28), "float32", True))


def backward_turn(device, kernel: str) -> None:
    """One turn of ``k5ab`` / ``k6ab`` (``kernel`` "k5" or "k6"), under whichever package
    the import path finds: the build's registers and spills, and ``k5_times`` /
    ``k6_times`` at the timed shape and K5_AB / K6_AB, as one JSON line."""
    import json

    import torch

    from ted_spad_tpu_torch.utils import cuda_build
    from ted_spad_tpu_torch.utils.cuda_build import ptxas_report

    name = {"k5": "maxpool3d", "k6": "upsample_bilinear"}[kernel]
    registers = ptxas_report(cuda_build.build(name)[1])
    if kernel == "k5":
        rows = [k5_times(device, *K5_TIMED, torch.bfloat16, True)]
        rows += [k5_times(device, *c[:4], getattr(torch, c[4]), c[5]) for c in K5_AB]
    else:
        rows = [k6_times(device, K6_TIMED, torch.float32, True)]
        rows += [k6_times(device, c[0], getattr(torch, c[1]), c[2]) for c in K6_AB]
    print(json.dumps({"registers": registers, "rows": rows}), flush=True)


def backward_ab(device, kernel: str, parent: str) -> None:
    """``k5ab`` / ``k6ab``: the kernel of ``parent`` (another checkout) and of this tree in
    turns, parent / change / change / parent, each turn a process of its own
    (``backwardturn``), both trees built first, at once; each turn's times, and whether
    the change was faster than the parent in every turn at every shape."""
    import json
    import os
    import subprocess

    name = {"k5": "maxpool3d", "k6": "upsample_bilinear"}[kernel]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parent = os.path.abspath(parent)
    turns = [("parent", parent), ("change", here), ("change", here), ("parent", parent)]
    code = f"from ted_spad_tpu_torch.utils.cuda_build import build; build({name!r})"
    builds = {root: subprocess.Popen([sys.executable, "-c", code], cwd=root,
                                     env={**os.environ, "PYTHONPATH": root}, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
              for root in (parent, here)}
    for root, proc in builds.items():
        out = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{kernel}ab: the build under {root} failed:\n{out[-3000:]}")
    turn = ("import runpy, sys; sys.argv = ['chip_probes', 'backwardturn', sys.argv[1]]; "
            f"runpy.run_path({os.path.abspath(__file__)!r}, run_name='__main__')")
    times = {}
    for i, (tag, root) in enumerate(turns):
        proc = subprocess.run([sys.executable, "-c", turn, kernel], cwd=root,
                              env={**os.environ, "PYTHONPATH": root}, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"registers"')]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"{kernel}ab turn {i} ({tag}) failed (exit {proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        reading = json.loads(lines[-1])
        regs = ", ".join(f"{k} {v['registers']}" + (f" (spills {v['spill_stores']} / {v['spill_loads']} B)"
                                                     if v["spill_stores"] or v["spill_loads"] else "")
                         for k, v in reading["registers"].items())
        print(f"[{kernel}ab] turn {i} {tag}: registers {regs}", flush=True)
        for r in reading["rows"]:
            times.setdefault(tag, {}).setdefault(str(r["shape"]), []).append(r["ms"])
            print(f"[{kernel}ab]     {r['shape']}: {times_line(r)}", flush=True)
    for shape, change in times["change"].items():
        parent_ms = times["parent"][shape]
        verdict = "faster in every turn" if max(change) < min(parent_ms) else "NOT faster in every turn"
        print(f"[{kernel}ab] {shape}: change {change} ms against parent {parent_ms} ms: {verdict}", flush=True)


# ---------------------------------------------------------------------------
# repeat: is the adversarial step repeatable on the card?
# ---------------------------------------------------------------------------

REPEAT_SEED = 1


def _bits(t):
    """An exact digest of a tensor's bits: the int64 sum of its elements read as
    integers of their width (order-free, so two equal tensors give equal digests
    whatever the reduction's order; two different ones almost surely differ). A device
    scalar, so recording one does not wait for the device."""
    import torch

    t = t.detach()
    if t.is_floating_point():
        t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t.sum(dtype=torch.int64)


@contextlib.contextmanager
def recorded(models: dict):
    """Record, in call order, the bit digest of every floating-point output of every
    module of ``models`` ({name: module}) that runs its forward (forward hooks: a
    remat recompute records again), and of the gradient reaching each such output in
    the backward (tensor hooks on the outputs). Yields (forward, backward), lists of
    (module, output index, digest)."""
    import torch

    forward, backward, handles = [], [], []

    def hook(name):
        def grad_hook(i):
            def record_grad(g):
                backward.append((name, i, _bits(g)))
            return record_grad

        def record(module, inputs, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for i, t in enumerate(outs):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    forward.append((name, i, _bits(t)))
                    if t.requires_grad:
                        t.register_hook(grad_hook(i))
        return record

    for tag, root in models.items():
        for name, module in root.named_modules():
            handles.append(module.register_forward_hook(hook(f"{tag}.{name}" if name else tag)))
    try:
        yield forward, backward
    finally:
        for h in handles:
            h.remove()


def repeat_run(models: dict, saved: dict, make_step, run) -> dict:
    """One run of a step from the saved state: each model's ``load_state_dict`` of
    ``saved``, a fresh step (``make_step()``: its optimizers new), ``run(step)`` with
    every module recorded (``recorded``). {"loss", "forward", "backward", "state"}: the
    losses, the records with their digests read, and every parameter and buffer after
    the step (clones)."""
    import torch

    for name, m in models.items():
        m.load_state_dict(saved[name])
        for q in m.parameters():
            q.grad = None
    step = make_step()
    with recorded(models) as (forward, backward):
        loss = run(step)
    state = {f"{name}.{k}": v.detach().clone() for name, m in models.items()
             for k, v in m.state_dict().items()}
    return {"loss": torch.as_tensor(loss).detach().float().cpu().tolist(),
            "forward": [(n, i, int(d)) for n, i, d in forward],
            "backward": [(n, i, int(d)) for n, i, d in backward], "state": state}


def repeat_compare(a: dict, b: dict) -> dict:
    """Two ``repeat_run`` readings: the losses' equality, the state entries bit-equal
    and differing, and the first forward and backward record that differs (its
    position, module and output index), or None."""
    import torch

    equal = [k for k in a["state"] if torch.equal(a["state"][k], b["state"][k])]

    def first(x, y):
        if [r[:2] for r in x] != [r[:2] for r in y]:
            return {"calls differ": True, "a": len(x), "b": len(y)}
        for i, (rx, ry) in enumerate(zip(x, y)):
            if rx[2] != ry[2]:
                return {"at": i, "of": len(x), "module": rx[0], "output": rx[1]}
        return None

    return {"loss_equal": a["loss"] == b["loss"], "equal": len(equal), "entries": len(a["state"]),
            "differing": [k for k in a["state"] if k not in set(equal)],
            "first_forward": first(a["forward"], b["forward"]),
            "first_backward": first(a["backward"], b["backward"])}


def repeat_steps(device, p, models: dict, inputs: tuple, seed: int = REPEAT_SEED) -> dict:
    """{name: (make_step, run)} of the adversarial fa step and fb/ft step over
    ``models`` ({"fa", "fb", "ft"}) and ``inputs`` (vispr1, vispr2, clips, labels), each
    step with new Adam optimizers and the fb/ft step's dropout generator seeded anew."""
    import torch

    from ted_spad_tpu_torch.stages import anonymization_training as anon
    from ted_spad_tpu_torch.stages.common import make_optimizer

    fa, fb, ft = models["fa"], models["fb"], models["ft"]

    def opt(m, lr):
        return make_optimizer(m.parameters(), p.opt_type, lr, p.weight_decay)

    def run(step):
        return step(*inputs)

    return {
        "fa step": (lambda: anon.make_fa_step(fa, fb, ft, opt(fa, p.learning_rate_fa), p, device=device),
                    run),
        "fb/ft step": (lambda: anon.make_fbft_step(
            fa, fb, ft, opt(fb, p.learning_rate_fb), opt(ft, p.learning_rate_ft), p,
            generator=torch.Generator(device=device).manual_seed(seed), device=device), run),
    }


def repeat_report(name: str, c: dict, tag: str = "repeat") -> str:
    """One line of ``repeat_compare``'s reading."""
    diff = c["differing"]
    return (f"[{tag}] {name}: losses {'equal' if c['loss_equal'] else 'differ'}; "
            f"{c['equal']} of {c['entries']} parameters and buffers bit-equal after the step"
            + (f" (differing, first 6 of {len(diff)}: {', '.join(diff[:6])})" if diff else "")
            + f"; first module output that differs: {c['first_forward']}; first gradient at a "
              f"module output that differs: {c['first_backward']}")


def adversarial_setup(device):
    """(params, models, inputs): AnonymizationParams' defaults (bf16, remat "auto"),
    the seeded full-width fa, fb and ft requiring grad, seeded inputs on the card."""
    import numpy as np
    import torch

    from ted_spad_tpu_torch.config.params import AnonymizationParams
    from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model

    p = AnonymizationParams()
    kw = dict(seed=0, dtype="float32", device=device)
    models = {"fa": load_fa_model(p.arch_fa, **kw).requires_grad_(True),
              "fb": load_fb_model(ssl=True, **kw).requires_grad_(True),
              "ft": load_ft_model(p.arch_ft, num_classes=p.num_classes, **kw).requires_grad_(True)}
    g = torch.Generator(device=device).manual_seed(REPEAT_SEED)
    side = (p.reso_h, p.reso_w, 3)
    v1, v2 = (torch.rand((p.batch_size_vispr,) + side, generator=g, device=device) for _ in range(2))
    clips = torch.rand((p.batch_size, 3, p.num_frames) + side, generator=g, device=device)
    labels = torch.from_numpy(np.random.default_rng(REPEAT_SEED).integers(0, p.num_classes, p.batch_size))
    return p, models, (v1, v2, clips, labels.to(device))


def moved(inputs: tuple, k: int) -> tuple:
    """``inputs`` with ``inputs[k]`` copied and one value moved by one level (1 for
    uint8, 1/255 else): the first row's value at the middle of its last two spatial axes,
    channel 0, so that no crop leaves it out. The repeat gate's control."""
    import numpy as np
    import torch

    x = inputs[k]
    x = x.clone() if isinstance(x, torch.Tensor) else np.array(x, copy=True)
    at = (0,) * (x.ndim - 3) + (x.shape[-3] // 2, x.shape[-2] // 2, 0)
    if x.dtype in (np.uint8, torch.uint8):
        x[at] = x[at] + 1 if int(x[at]) < 255 else x[at] - 1
    else:
        x[at] = x[at] + 1 / 255
    return inputs[:k] + (x,) + inputs[k + 1:]


def action_repeat_steps(device, p, ft, inputs: tuple, seed: int = REPEAT_SEED) -> dict:
    """{"action step": (make_step, run)}: the action training step over ``ft`` (a new
    optimizer, the dropout generator seeded anew) on ``inputs`` (clips, labels, draw)."""
    import torch

    from ted_spad_tpu_torch.stages import action_training
    from ted_spad_tpu_torch.stages.common import make_optimizer

    return {"action step": (
        lambda: action_training.make_train_step(
            ft, make_optimizer(ft.parameters(), p.opt_type, p.learning_rate, p.weight_decay, p.momentum),
            p, generator=torch.Generator(device=device).manual_seed(seed), device=device),
        lambda step: step(*inputs))}


def fa_pretraining_repeat_steps(device, rp, fa, inputs: tuple) -> dict:
    """{"fa pretraining step": (make_step, run)} over ``fa`` on ``inputs`` (images,
    draw)."""
    from ted_spad_tpu_torch.stages import fa_pretraining
    from ted_spad_tpu_torch.stages.common import make_optimizer

    return {"fa pretraining step": (
        lambda: fa_pretraining.make_train_step(fa, make_optimizer(fa.parameters(), "adam", rp.learning_rate),
                                               (rp.reso_h, rp.reso_w), compute_dtype=rp.compute_dtype,
                                               device=device),
        lambda step: step(*inputs))}


def privacy_repeat_steps(device, pp, fb, fa, inputs: tuple) -> dict:
    """{"privacy step": (make_step, run)}: the privacy attacker's step over ``fb``
    through the frozen ``fa`` on ``inputs`` (images, labels, draw)."""
    from ted_spad_tpu_torch.stages.common import make_optimizer
    from ted_spad_tpu_torch.stages.privacy_training import make_steps

    return {"privacy step": (
        lambda: make_steps(fb, fa, make_optimizer(fb.parameters(), "adam", pp.learning_rate),
                           (pp.reso_h, pp.reso_w), compute_dtype=pp.compute_dtype, device=device)[0],
        lambda step: step(*inputs))}


def mgfn_repeat_steps(device, p, model, inputs: tuple, seed: int = REPEAT_SEED) -> dict:
    """{"MGFN step": (make_step, run)}: the MGFN train step (a new Adam, the dropout
    generator seeded anew) on ``inputs`` (nfeat, nlabel, afeat, alabel)."""
    import torch

    from ted_spad_tpu_torch.stages import anomaly_detection

    return {"MGFN step": (
        lambda: anomaly_detection.make_train_step(
            model, anomaly_detection.make_optimizer(model, p), p,
            generator=torch.Generator(device=device).manual_seed(seed), device=device),
        lambda step: step(*inputs))}


def with_control(steps_of, inputs: tuple, k: int) -> dict:
    """{name: (make_step, run, control)}: ``steps_of(inputs)``'s steps, each with the
    run on ``moved(inputs, k)`` beside it."""
    steps, control = steps_of(inputs), steps_of(moved(inputs, k))
    return {name: (make, run, control[name][1]) for name, (make, run) in steps.items()}


def _k5k6_launches() -> tuple[int, int]:
    from ted_spad_tpu_torch.ops.maxpool3d import max_pool3d_backward
    from ted_spad_tpu_torch.ops.upsample import upsample_bilinear_backward

    return max_pool3d_backward.launches, upsample_bilinear_backward.launches


def repeat_case(models: dict, make_step, run, control) -> dict:
    """A step run twice from one saved state, batch and draw and once on the control's
    inputs (``repeat_run``): {"same": the two runs compared, "control": the first run
    against the control's (``repeat_compare``), "launches": K5's and K6's launches in
    each run, "records": the first run's forward and backward records, "seconds"}. The
    models hold the control's state afterwards."""
    saved = {k: {n: v.detach().clone() for n, v in m.state_dict().items()} for k, m in models.items()}
    t0 = time.perf_counter()
    runs, launches = [], []
    for fn in (run, run, control):
        before = _k5k6_launches()
        runs.append(repeat_run(models, saved, make_step, fn))
        launches.append(tuple(b - a for a, b in zip(before, _k5k6_launches())))
    return {"same": repeat_compare(runs[0], runs[1]), "control": repeat_compare(runs[0], runs[2]),
            "launches": launches, "records": (len(runs[0]["forward"]), len(runs[0]["backward"])),
            "seconds": time.perf_counter() - t0}


def repeat_gate(r: dict) -> tuple[bool, bool]:
    """(the step repeated: losses equal and every parameter and buffer bit-equal; the
    control differs in what that compares)."""
    def same(c):
        return c["loss_equal"] and c["equal"] == c["entries"]

    return same(r["same"]), not same(r["control"])


def repeat_groups(device) -> list:
    """Phase 19's steps at full width, in groups that share models: [(group, build)],
    ``build()`` -> (models {tag: module}, {name: (make_step, run, control)}, K5 and K6
    expected: (bool, bool)) for each step of the group. Inputs are seeded; each group is
    built when its turn comes, so one group's models are on the card at a time."""
    import numpy as np
    import torch

    from ted_spad_tpu_torch.config.params import (
        ActionParams, AnonymizationParams, MGFNParams, PrivacyParams, ReconstructionParams,
    )
    from ted_spad_tpu_torch.data.images import SyntheticImageSource, sample_image_augment_params
    from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model
    from ted_spad_tpu_torch.ops.augment import sample_augment_params

    kw = dict(seed=0, dtype="float32", device=device)

    def adversarial(arch_fa="unet++", arch_ft="largei3d", cut=None, steps=("fa step", "fb/ft step")):
        def build():
            p = AnonymizationParams(arch_fa=arch_fa, arch_ft=arch_ft)
            if cut:  # (videos, VISPR pairs)
                p = p.replace(batch_size=cut[0], batch_size_vispr=cut[1])
            models = {"fa": load_fa_model(arch_fa, **kw).requires_grad_(True),
                      "fb": load_fb_model(ssl=True, **kw).requires_grad_(True),
                      "ft": load_ft_model(arch_ft, num_classes=p.num_classes,
                                          clip_shape=(p.num_frames, p.reso_h, p.reso_w),
                                          **kw).requires_grad_(True)}
            g = torch.Generator(device=device).manual_seed(REPEAT_SEED)
            side = (p.reso_h, p.reso_w, 3)
            v1, v2 = (torch.rand((p.batch_size_vispr,) + side, generator=g, device=device) for _ in range(2))
            clips = torch.rand((p.batch_size, 3, p.num_frames) + side, generator=g, device=device)
            labels = torch.from_numpy(np.random.default_rng(REPEAT_SEED).integers(0, p.num_classes,
                                                                                   p.batch_size)).to(device)
            cases = with_control(lambda i: repeat_steps(device, p, models, i), (v1, v2, clips, labels), 2)
            return models, {k: v for k, v in cases.items() if k in steps}
        return build

    def action():
        ap = ActionParams(temporal_loss="trip")
        ft = load_ft_model(ap.arch, num_classes=ap.num_classes, dropout_rate=ap.ft_dropout or None,
                           **kw).requires_grad_(True)
        rng = np.random.default_rng(REPEAT_SEED)
        b = ap.batch_size
        clips = torch.from_numpy(rng.integers(0, 256, (b, 3, ap.num_frames, 240, 320, 3),
                                              dtype=np.uint8)).to(device)
        inputs = (clips, rng.integers(0, ap.num_classes, b), sample_augment_params(rng, b * 3, 240, 320,
                                                                                  ap.reso_h, ap.reso_w))
        return {"ft": ft}, with_control(lambda i: action_repeat_steps(device, ap, ft, i), inputs, 0)

    def fa_pretraining(arch):
        def build():
            rp = ReconstructionParams()
            fa = load_fa_model(arch, **kw).requires_grad_(True)
            rng = np.random.default_rng(REPEAT_SEED)
            images = torch.from_numpy(rng.integers(0, 256, (rp.batch_size, 256, 256, 3),
                                                   dtype=np.uint8)).to(device)
            inputs = (images, sample_image_augment_params(rng, rp.batch_size, 256, rp.reso_h, rp.reso_w))
            return {"fa": fa}, with_control(lambda i: fa_pretraining_repeat_steps(device, rp, fa, i),
                                            inputs, 0)
        return build

    def privacy():
        pp = PrivacyParams()
        fb = load_fb_model(num_pa=pp.num_pa, **kw).requires_grad_(True)
        fa = load_fa_model(seed=0, dtype=pp.compute_dtype, device=device)
        src = SyntheticImageSource(n=pp.batch_size, seed=REPEAT_SEED)
        images, labels = src.get_batch(list(range(pp.batch_size)))
        rng = np.random.default_rng(REPEAT_SEED)
        inputs = (torch.from_numpy(images).to(device), labels,
                  sample_image_augment_params(rng, pp.batch_size, src.canonical, pp.reso_h, pp.reso_w))
        return {"fb": fb}, with_control(lambda i: privacy_repeat_steps(device, pp, fb, fa, i), inputs, 0)

    def mgfn():
        p = MGFNParams.for_dataset("UCF")
        model = perturbed_mgfn(p, device)
        return {"mgfn": model}, with_control(lambda i: mgfn_repeat_steps(device, p, model, i),
                                             mgfn_batch(p, seed=REPEAT_SEED), 2)

    # (group, build, K5 expected, K6 expected)
    return [
        ("adversarial (UNet++, ResNet50SSL, I3Res50)", adversarial(), True, False),
        ("action (I3Res50 + head)", action, True, False),
        ("fa pretraining (UNet++)", fa_pretraining("unet++"), False, False),
        ("fa pretraining (UNet)", fa_pretraining("unet"), False, True),
        ("adversarial (UNet++, ResNet50SSL, InceptionI3d)", adversarial(arch_ft="i3d"), True, False),
        ("adversarial (UNet++, ResNet50SSL, MViTv2-S)", adversarial(arch_ft="mvitv2"), True, False),
        # The plain UNet's fa step at the defaults' 408 frames of 224^2 does not fit in 80 GB:
        # chip_smoke.py's phase 13 driver batch.
        ("adversarial (UNet, ResNet50SSL, I3Res50; 2 videos, 4 pairs)",
         adversarial("unet", cut=(2, 4), steps=("fa step",)), True, True),
        ("privacy (ResNet50Classifier, frozen UNet++)", privacy, False, False),
        ("MGFN (UCF)", mgfn, False, False),
    ]


def repeat_line(group: str, name: str, r: dict, tag: str = "repeat") -> str:
    """One line of a ``repeat_case`` reading: the gate, the control, the launches."""
    ok, control = repeat_gate(r)
    return (f"{repeat_report(f'{group} {name}', r['same'], tag)}; control (one input value moved by one "
            f"level) {'differs' if control else 'DOES NOT differ'} (losses "
            f"{'equal' if r['control']['loss_equal'] else 'differ'}, {r['control']['equal']} of "
            f"{r['control']['entries']} bit-equal); K5 / K6 launches per run {r['launches']}; "
            f"{r['seconds']:.1f} s; gate {'holds' if ok else 'FAILS'}")


@contextlib.contextmanager
def without_cudnn_repair():
    """Inside the block the training stages run without their deterministic cuDNN scope
    (utils/device.deterministic_cudnn becomes a no-op in the stages that call it): the
    steps as they ran before the repair, for ``repeat``'s reading and ``repairab``."""
    from ted_spad_tpu_torch.stages import (
        action_training, anomaly_detection, anonymization_training, fa_pretraining, privacy_training,
    )

    mods = (action_training, anomaly_detection, anonymization_training, fa_pretraining, privacy_training)
    saved = [(m, m.deterministic_cudnn) for m in mods]
    for m in mods:
        m.deterministic_cudnn = contextlib.nullcontext
    try:
        yield
    finally:
        for m, fn in saved:
            m.deterministic_cudnn = fn


def _repeat_all(device, tag: str, variants=(("", contextlib.nullcontext),)) -> None:
    """Each step of ``repeat_groups`` run twice from the same saved state and once on
    its control (``repeat_case``), under each of ``variants`` ((label, context))."""
    import torch

    for group, build, _, _ in repeat_groups(device):
        models, cases = build()
        for name, (make_step, run, control) in cases.items():
            for label, ctx in variants:
                with ctx():
                    r = repeat_case(models, make_step, run, control)
                print(repeat_line(group, name + label, r, tag), flush=True)
        del models, cases
        torch.cuda.empty_cache()


def repeat(device) -> None:
    """See the module docstring."""
    import os
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[repeat] {card}", flush=True)
    _repeat_all(device, "repeat", (("", contextlib.nullcontext),
                                   (" (without the cuDNN repair)", without_cudnn_repair)))
    # Deterministic algorithms need cuBLAS's workspace set before its first handle: a
    # process of its own.
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, "-m", "ted_spad_tpu_torch.chip_probes", "repeatdet"],
                          env=env, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"repeatdet exited with {proc.returncode}")


def repeat_deterministic(device) -> None:
    """``repeat``'s runs under ``torch.use_deterministic_algorithms(True, warn_only=True)``
    (CUBLAS_WORKSPACE_CONFIG set by ``repeat``): every op that warns for lack of a
    deterministic form, then the runs compared."""
    import os
    import warnings

    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _repeat_all(device, "repeat, deterministic")
    ops = sorted({str(w.message).splitlines()[0] for w in caught
                  if "deterministic" in str(w.message)})
    print(f"[repeat, deterministic] CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')}; "
          f"ops without a deterministic form ({len(ops)}): {ops}", flush=True)


REPAIR_TURNS = ("repaired", "unrepaired", "unrepaired", "repaired")


def repair_ab(device, make_step, run, turns=REPAIR_TURNS, n: int = TRAINAB_STEPS, warmup: int = 2) -> dict:
    """One step with the deterministic cuDNN scope ("repaired") and without it
    (``without_cudnn_repair``) in alternating ``turns`` after a discarded one, each a
    ``train_turn`` without a profile: {label: [its readings]}."""
    import torch

    out = {"repaired": [], "unrepaired": []}
    for i, label in enumerate((turns[0],) + tuple(turns)):
        with without_cudnn_repair() if label == "unrepaired" else contextlib.nullcontext():
            r = train_turn(device, make_step, run, n, warmup, profile=False)
        torch.cuda.empty_cache()
        if i:
            out[label].append(r)
    return out


def repair_summary(ab: dict) -> str:
    """``repair_ab``'s readings in one line: each label's median step over its turns,
    the turns' medians, and the cost of the repair."""
    import statistics

    med = {k: statistics.median(x for r in rs for x in r["ms"]) for k, rs in ab.items()}
    turns = {k: " / ".join(f"{statistics.median(r['ms']):.3f}" for r in rs) for k, rs in ab.items()}
    return (f"repaired median {med['repaired']:.3f} ms (turns {turns['repaired']}), unrepaired "
            f"{med['unrepaired']:.3f} ms (turns {turns['unrepaired']}): the repair costs "
            f"{100 * (med['repaired'] / med['unrepaired'] - 1):+.2f}% of the step")


def repairab(device) -> None:
    """See the module docstring."""
    import subprocess

    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[repairab] {card}", flush=True)
    for group, build, _, _ in repeat_groups(device):
        models, cases = build()
        for name, (make_step, run, _) in cases.items():
            print(f"[repairab] {group} {name}: {repair_summary(repair_ab(device, make_step, run))} | {card}",
                  flush=True)
        del models, cases
        torch.cuda.empty_cache()


@contextlib.contextmanager
def torch_atomic_backwards():
    """Inside the block the models pool and upsample through torch's own functions, whose
    CUDA backwards add with atomics (the port before K5 and K6): ``models.layers``' and
    ``models.mvit``'s ``max_pool3d`` become ``F.max_pool3d``, ``resize_bilinear``'s
    upsample ``F.interpolate``."""
    import torch.nn.functional as F

    from ted_spad_tpu_torch.models import layers, mvit

    def upsample(x):
        return F.interpolate(x, size=(x.shape[2] * 2, x.shape[3] * 2), mode="bilinear", align_corners=True)

    saved = [(layers, "max_pool3d", layers.max_pool3d), (mvit, "max_pool3d", mvit.max_pool3d),
             (layers, "upsample_bilinear", layers.upsample_bilinear)]
    layers.max_pool3d = mvit.max_pool3d = F.max_pool3d
    layers.upsample_bilinear = upsample
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def validate_repeat(device, backwards: str = "port") -> None:
    """``validate_adversarial --scale reference`` cut to one adversarial and one attack
    epoch (chip_smoke.py's phase 17 cut), run twice from one seed, each in a save
    directory of its own: both cMAPs and every history compared bit for bit. With
    ``backwards`` "atomic" both runs pool and upsample through torch's atomic backwards
    (``torch_atomic_backwards``), as the port did before K5 and K6."""
    import subprocess
    import tempfile

    import torch

    from ted_spad_tpu_torch import validate_adversarial

    if backwards not in ("port", "atomic"):
        raise ValueError(f"validaterepeat takes 'port' or 'atomic', not {backwards!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[validaterepeat] backwards: {backwards} | {card}", flush=True)
    runs, states = [], []
    for i in range(2):
        with tempfile.TemporaryDirectory() as d, \
                torch_atomic_backwards() if backwards == "atomic" else contextlib.nullcontext():
            args = ["--scale", "reference", "--epochs", "1", "--attack_epochs", "1", "--seed", "0",
                    "--device", str(device), "--save_dir", d]
            r = validate_adversarial.run(validate_adversarial.parser().parse_args(args))
        runs.append({k: {"history": r[k]["history"], "best": r[k].get("best_cmap", r[k].get("best_acc"))}
                     for k in ("anon", "raw", "anonymized")})
        states.append({k: v.detach().clone() for k, v in r["anon"]["fa"].state_dict().items()})
        print(f"[validaterepeat] run {i}: cMAP raw {r['raw']['best_cmap']!r}, anonymized "
              f"{r['anonymized']['best_cmap']!r}, delta {r['delta']!r} | {card}", flush=True)
        del r
        torch.cuda.empty_cache()
    differ = [f"{k}.{part}" for k in runs[0] for part in ("history", "best")
              if repr(runs[0][k][part]) != repr(runs[1][k][part])]
    fa_differ = [k for k in states[0] if not torch.equal(states[0][k], states[1][k])]
    print(f"[validaterepeat] histories and best values of the three stages: {len(differ)} of 6 differ "
          f"{differ}; the adversarial fa: {len(fa_differ)} of {len(states[0])} tensors differ "
          f"{fa_differ[:6]} | {card}", flush=True)


def main() -> int:
    import torch

    probes = {"k1": k1, "k2": k2, "k3": k3, "k4": k4, "k4class": k4class, "gain": gain, "mgfn": mgfn,
              "int8ab": int8ab, "int8step": int8_step_turn, "k3ab": k3ab, "k3turn": k3_turn,
              "k2ab": k2ab, "k2turn": k2_turn, "fastforms": fastforms, "stepab": stepab,
              "stepturn": step_turn, "trainab": trainab, "repeat": repeat,
              "repeatdet": repeat_deterministic, "k5": k5, "k6": k6, "repairab": repairab,
              "validaterepeat": validate_repeat, "backwardturn": backward_turn,
              "k5ab": lambda device, parent: backward_ab(device, "k5", parent),
              "k6ab": lambda device, parent: backward_ab(device, "k6", parent)}
    takes_arg = ("int8ab", "int8step", "k3turn", "stepab", "stepturn", "backwardturn", "k5ab", "k6ab")
    n_args = len(sys.argv) - 2
    if (len(sys.argv) < 2 or sys.argv[1] not in probes
            or (n_args < 1 if sys.argv[1] in ("k3ab", "k2ab") else
                n_args > 1 if sys.argv[1] == "validaterepeat" else n_args != (sys.argv[1] in takes_arg))):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_probes: needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    probes[sys.argv[1]](torch.device("cuda", 0), *sys.argv[2:])
    print(f"{sys.argv[1]} done in {time.perf_counter() - t0:.1f}s on "
          f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
