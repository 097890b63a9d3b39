"""Capture a profiler trace of a stage's hot step (counterpart of
scripts/profile_stage.py): ``torch.profiler`` through ``utils.logging.profile_trace``,
one Chrome trace (Perfetto, chrome://tracing) under ``--out``.

    python -m ted_spad_tpu_torch.profile_stage --stage extraction --out logs/profile_extraction

``--stage extraction``: the serving step (preprocess K1 -> UNet++ fa -> I3Res50 ft) on 4
clips, 3 steps after a warm-up; on the card at the serving shapes (16 x 224^2, bf16),
with ``--device cpu`` at 8 x 64^2 in float32. ``--stage mgfn``: 5 MGFN train steps
(feature 256, dims 64/128/256, 8 + 8 videos of 2 crops x 32 segments). The trace
holds the host's operators and, on the card, its kernels and copies.
"""

from __future__ import annotations

import argparse


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--stage", type=str, default="extraction",
                    choices=["extraction", "mgfn", "anonymizer"])
    ap.add_argument("--out", type=str, default=None, help="trace directory "
                    "(default logs/profile_<stage>)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; 'cpu' profiles the CPU at small shapes)")
    return ap


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> str:
    """Profile the stage; returns the trace directory."""
    import numpy as np
    import torch

    from ted_spad_tpu_torch.utils.device import resolve_device
    from ted_spad_tpu_torch.utils.logging import profile_trace

    if args.stage == "anonymizer":
        raise SystemExit("anonymizer profiling: run scripts/train_anonymizer.py under profile_trace")
    device = resolve_device(args.device)
    out = args.out or f"logs/profile_{args.stage}"
    if args.stage == "extraction":
        from ted_spad_tpu_torch.config.params import FeatureExtractionParams
        from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
        from ted_spad_tpu_torch.stages.feature_extraction import make_extract_step

        cpu = device.type == "cpu"
        size = 64 if cpu else 224
        p = FeatureExtractionParams(num_frames=8 if cpu else 16, reso_h=size, reso_w=size,
                                    compute_dtype="float32" if cpu else "bfloat16")
        fa = load_fa_model(p.arch_fa, dtype=p.compute_dtype, device=device)
        ft = load_ft_model("largei3d", num_classes=102, clip_shape=(p.num_frames, size, size),
                           dtype=p.compute_dtype, device=device)
        step = make_extract_step(ft, p, fa, device=device)
        clips = torch.from_numpy(np.random.default_rng(0).integers(
            0, 255, (4, p.num_frames, size + 16, size + 32, 3), dtype=np.uint8)).to(device)
        step(clips)  # first calls (cuDNN plans, kernel loads) outside the trace
        _sync(device)
        with profile_trace(out):
            for _ in range(3):
                step(clips)
            _sync(device)
    else:
        from ted_spad_tpu_torch.config.params import MGFNParams
        from ted_spad_tpu_torch.models import load_mgfn_model
        from ted_spad_tpu_torch.stages.anomaly_detection import make_optimizer, make_train_step

        p = MGFNParams(feature_size=256, dims=(64, 128, 256), dim_head=64, batch_size=8)
        model = load_mgfn_model(p, device=device).requires_grad_(True)
        step = make_train_step(model, make_optimizer(model, p), p,
                               generator=torch.Generator(device=device).manual_seed(0),
                               device=device)
        r = np.random.default_rng(0)
        n = r.normal(0, 1, (8, 2, 32, 257)).astype(np.float32)
        a = r.normal(0, 1, (8, 2, 32, 257)).astype(np.float32)
        nlab, alab = np.zeros(8, np.float32), np.ones(8, np.float32)
        step(n, nlab, a, alab)  # warm-up outside the trace
        _sync(device)
        with profile_trace(out):
            for _ in range(5):
                step(n, nlab, a, alab)
            _sync(device)
    print(f"trace written to {out}")
    return out


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
