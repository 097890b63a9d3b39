"""Measurements on a CUDA card that informed the port's kernels, kept so that the
numbers PERF.md quotes from them can be taken again:

    python -m ted_spad_tpu_torch.chip_probes k1     # kernel K1 alone
    python -m ted_spad_tpu_torch.chip_probes k2     # kernel K2 alone
    python -m ted_spad_tpu_torch.chip_probes k3     # kernel K3 (YUV420 preprocess) alone
    python -m ted_spad_tpu_torch.chip_probes k4     # kernel K4 (int8 conv) alone
    python -m ted_spad_tpu_torch.chip_probes gain   # the UNet's outc gain vs the gates
    python -m ted_spad_tpu_torch.chip_probes mgfn   # where MGFN's card-vs-CPU step error sits

``k1``: builds K1 and prints each instantiation's registers and spills, holds it
against its plain version (float32 matmuls, TF32 off) at K1_CASES and over the crops
of K1_CROP_CASES in f32 and bf16, then times it alone at the serving shape, bf16 out (``time_ms``, as chip_smoke.py
times every kernel, and its device-only reading beside), next to its byte bound, the
plain version and both library yardsticks, and at K1_FRAME_SIZES.

``k2``: builds K2 and prints each instantiation's registers and spills (failing if
the bf16 kernels spill), holds it against its plain version (float32 convs, TF32 off)
at the plain UNet's nine DoubleConv shapes with two frames and at one ragged shape per
bf16 tile class, in f32 and bf16, then times the kernel alone at 256 frames (CUDA
events), with each shape's tile class.

``k3``: builds K3, prints its registers, holds it against its plain version (float32
matmuls, TF32 off) at K3_CASES in f32 and bf16 and checks its refusal of a
chroma-misaligned window, then times it at the serving batch and at K3_FRAME_SIZES beside
its byte bound, the plain version and the per-plane F.interpolate yardstick.

``k4``: builds K4, prints its registers, holds it bit for bit against its plain version
(float64 convolutions of the codes, exact) at K4_CASES in bf16 and f32, then times it
alone at three serving shapes beside its bound and the cuDNN bf16 conv (and
``torch._int_mm`` + the epilogue at the 1x1x1 shape).

``gain``: the random-init UNet's sigmoid output sits near 0.5, so the bf16 ft's own
rounding can swamp the differences between clips. For outc gains 1, 4, 8 and 16 it
prints the fa output's spread and both fidelity readings of chip_smoke.py (features
and fa output, bf16 kernel path against the f32 plain path, with their controls).

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


def k2_register_report(nvcc_out: str, log=print) -> dict[str, dict[str, int]]:
    """Each K2 instantiation's registers and spill bytes from nvcc's ptxas report,
    logged and keyed "bf16 Cls<...>" as ``k2_tile_plan(...).kernel`` names it, or
    "f32 4x8"; raises if a bf16 one spills."""
    from ted_spad_tpu_torch.utils import cuda_build

    report = {}
    for name, r in cuda_build.ptxas_report(nvcc_out).items():
        if "double_conv_bf16" in name:
            args = re.findall(r"Li(\d+)E", re.search(r"ClsI(.*?)EE", name).group(1) + "E")
            label = f"bf16 Cls<{', '.join(args)}>"
        else:
            label = "f32 4x8"
        report[label] = r
        log(f"[K2 build] {label}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} B, spill loads {r['spill_loads']} B")
        if label.startswith("bf16") and (r["spill_stores"] or r["spill_loads"]):
            raise AssertionError(f"the bf16 K2 {label} spills registers: {r}")
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
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)):
            args = double_conv_operands(device, shape, dtype)
            got = dc.fused_double_conv(*args)
            with tf32_off():
                ref = dc.double_conv_reference(*args)
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            worst = max(worst, err / scale / tol)
            print(f"{name} {shape} {str(dtype)[6:]}: max|kernel - plain| {err:.3e} = "
                  f"{err / scale:.3e} of max|plain| {scale:.3f} (tolerance {tol:.3e})", flush=True)
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
# colour sets; rows without a tag; ShanghaiTech's native frame (runtime taps); the
# serving batch at an odd base address (every row unaligned); a small frame.
K3_CASES = (
    ("serving, four colour sets", (16, 16, 240, 320), True, 0),
    ("serving, untagged rows", (2, 16, 240, 320), False, 0),
    ("480x856", (2, 8, 480, 856), True, 0),
    ("serving at base + 1 B", (2, 16, 240, 320), True, 1),
    ("40x80", (2, 3, 40, 80), True, 0),
)
K3_MISALIGNED = (1, 2, 50, 70)  # 0.8 of 50 rows starts at row 5: refused
K3_FRAME_SIZES = ((16, 16, 480, 856),)
# F.interpolate's own filter arithmetic on 0..255 planes, through the colour matrix.
K3_INTERPOLATE_TOL = 5e-4

# K4 against its plain version, bit for bit: (name, x shape NHWC / NDHWC, kernel shape
# HWIO / DHWIO, strides, pads, lhs dilation). The ragged cases of the int8 path beside the
# shapes chip_smoke.py records from it: Cin 3 (the I3Res50 stem through K4), odd H/W, stride
# 2, the (3, 1, 1) temporal taps, the up2_int8 4x4 form, a ragged Cout and Cin 48, wide
# Cout, asymmetric pads.
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
    ("up2_int8 4x4 dilated", (2, 28, 28, 64), (4, 4, 64, 32), (1, 1), ((2, 2), (2, 2)), (2, 2)),
    ("1x1x1 512->2048", (1, 2, 7, 7, 512), (1, 1, 1, 512, 2048), (1, 1, 1),
     ((0, 0), (0, 0), (0, 0)), None),
    ("asymmetric pads", (1, 9, 10, 32), (3, 3, 32, 24), (1, 1), ((0, 2), (1, 0)), None),
)
INT8_TOPS = 1979e12  # H100 SXM dense int8 tensor-core rate


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


def k3(device) -> None:
    from ted_spad_tpu_torch.utils import cuda_build

    seconds, nvcc_out = cuda_build.build("preprocess_yuv")
    for name, r in cuda_build.ptxas_report(nvcc_out).items():
        print(f"[K3 build] {name}: {r}", flush=True)
    print(f"build {seconds:.2f}s", flush=True)
    print(f"worst max abs error {k3_check(device):.3e}", flush=True)
    k3_timing(device)
    for shape in K3_FRAME_SIZES:
        k3_timing(device, shape=shape)


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


def k4_call(x, weight, strides, padding, dilation, use_kernel: bool = True, scale: float = 0.05,
            out_dtype=None):
    import torch

    from ted_spad_tpu_torch.ops.int8conv import int8_conv

    return int8_conv(x, weight, scale, strides=strides, padding=padding, lhs_dilation=dilation,
                     out_dtype=out_dtype or torch.bfloat16, use_kernel=use_kernel)


def k4_check(device, cases, log=print, tag: str = "[K4]") -> int:
    """K4 against int8_conv_reference on the card, bf16 and f32 out, bit for bit, at each
    (name, x shape, kernel shape, strides, pads, dilation) of ``cases``. Returns the
    number of elements compared."""
    import torch

    n = 0
    for i, (name, xs, ws, st, pads, dil) in enumerate(cases):
        x, weight = k4_operands(device, xs, ws, seed=60 + i)
        for dtype in (torch.bfloat16, torch.float32):
            got = k4_call(x, weight, st, pads, dil, out_dtype=dtype)
            ref = k4_call(x, weight, st, pads, dil, use_kernel=False, out_dtype=dtype)
            torch.cuda.synchronize()
            same = got.shape == ref.shape and torch.equal(got, ref)
            diff = int((got != ref).sum()) if got.shape == ref.shape else -1
            log(f"{tag} {name} x{tuple(xs)} w{tuple(ws)} s{tuple(st)} p{tuple(pads)} "
                f"d{dil} {str(dtype)[6:]}: {'bit-equal' if same else f'{diff} elements differ'} "
                f"({got.numel()} elements)")
            if not same:
                raise AssertionError(f"K4 differs from its plain version at {name}")
            n += got.numel()
    return n


def k4_bound(x_shape, w_shape, out_shape, out_bytes: int = 2) -> tuple[float, float]:
    """(ms by operations, ms by bytes) of one int8 conv: 2 * taps * Cin * Cout operations
    per output pixel at the int8 tensor-core rate; the activations, the weights and the
    scales read once, the output written once, at the memory rate."""
    import math

    taps_cin = math.prod(w_shape[:-1])
    m = math.prod(out_shape[:-1])
    ops = 2 * m * taps_cin * w_shape[-1]
    bytes_moved = (math.prod(x_shape) + taps_cin * w_shape[-1] + 4 * w_shape[-1]
                   + m * w_shape[-1] * out_bytes)
    return ops / INT8_TOPS * 1e3, bytes_moved / HBM_BYTES_PER_S * 1e3


def k4_library(x, weight, strides, padding, dilation, scale: float = 0.05):
    """The yardsticks of one int8 conv shape, never called by the port: (the cuDNN bf16
    conv it replaces, on the dequantized operands; torch._int_mm + the same epilogue at a
    1x1 / 1x1x1 unstrided, unpadded shape, else None), each a zero-argument callable."""
    import torch
    import torch.nn.functional as F

    from ted_spad_tpu_torch.ops.int8conv import channel_scale, epilogue

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
        if a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0:
            int_mm = lambda: epilogue(torch._int_mm(a, b), sc, torch.bfloat16)  # noqa: E731
    return cudnn, int_mm


def k4(device) -> None:
    import torch

    from ted_spad_tpu_torch.utils import cuda_build

    seconds, nvcc_out = cuda_build.build("int8conv")
    for name, r in cuda_build.ptxas_report(nvcc_out).items():
        print(f"[K4 build] {name}: {r}", flush=True)
    print(f"build {seconds:.2f}s", flush=True)
    print(f"{k4_check(device, K4_CASES)} elements bit-equal", flush=True)
    # Alone at a few serving shapes (256 frames / 16 clips).
    for name, xs, ws, st, pads, dil in (
        ("enc layer1 3x3 64->64", (256, 56, 56, 64), (3, 3, 64, 64), (1, 1), ((1, 1),) * 2, None),
        ("dec x_0_2 conv2 64->64", (256, 112, 112, 64), (3, 3, 64, 64), (1, 1), ((1, 1),) * 2, None),
        ("ft l3 1x1x1 1024->256", (16, 4, 14, 14, 1024), (1, 1, 1, 1024, 256), (1, 1, 1),
         ((0, 0),) * 3, None),
    ):
        x, weight = k4_operands(device, xs, ws)
        out = k4_call(x, weight, st, pads, dil)
        ms = time_ms(lambda: k4_call(x, weight, st, pads, dil), reps=5, inner=2)
        cudnn, int_mm = k4_library(x, weight, st, pads, dil)
        lib_ms = time_ms(cudnn, reps=5, inner=2)
        mm_ms = time_ms(int_mm, reps=5, inner=2) if int_mm else None
        by_ops, by_bytes = k4_bound(xs, ws, tuple(out.shape))
        print(f"[K4] {name} x{xs}: kernel {ms:.4f} ms, bound {max(by_ops, by_bytes):.4f} ms "
              f"(operations {by_ops:.4f}, bytes {by_bytes:.4f}), cuDNN bf16 {lib_ms:.4f} ms, "
              f"_int_mm + epilogue {mm_ms}", flush=True)
        del x, out
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if len(sys.argv) != 2 or sys.argv[1] not in ("k1", "k2", "k3", "k4", "gain", "mgfn"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_probes: needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    {"k1": k1, "k2": k2, "k3": k3, "k4": k4, "gain": gain,
     "mgfn": mgfn}[sys.argv[1]](torch.device("cuda", 0))
    print(f"{sys.argv[1]} done in {time.perf_counter() - t0:.1f}s on "
          f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
