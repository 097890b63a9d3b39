"""Two measurements on a CUDA card that informed the plain-UNet slice, kept so that
the numbers PERF.md quotes from them can be taken again:

    python -m ted_spad_tpu_torch.chip_probes k2     # kernel K2 alone
    python -m ted_spad_tpu_torch.chip_probes gain   # the UNet's outc gain vs the gates

``k2``: builds K2 and prints each instantiation's registers and spills (failing if
the bf16 kernels spill), holds it against its plain version (float32 convs, TF32 off)
at the plain UNet's nine DoubleConv shapes with two frames and at one ragged shape per
bf16 tile class, in f32 and bf16, then times the kernel alone at 256 frames (CUDA
events), with each shape's tile class.

``gain``: the random-init UNet's sigmoid output sits near 0.5, so the bf16 ft's own
rounding can swamp the differences between clips. For outc gains 1, 4, 8 and 16 it
prints the fa output's spread and both fidelity readings of chip_smoke.py (features
and fa output, bf16 kernel path against the f32 plain path, with their controls).
"""

from __future__ import annotations

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


def main() -> int:
    import torch

    if len(sys.argv) != 2 or sys.argv[1] not in ("k2", "gain"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_probes: needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    {"k2": k2, "gain": gain}[sys.argv[1]](torch.device("cuda", 0))
    print(f"{sys.argv[1]} done in {time.perf_counter() - t0:.1f}s on "
          f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
