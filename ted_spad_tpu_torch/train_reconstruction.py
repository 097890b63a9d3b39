"""fa pretraining on a CUDA card (counterpart of scripts/train_reconstruction.py;
reference fa_pretraining/train_reconstruction.py).

    python -m ted_spad_tpu_torch.train_reconstruction --ucf_frames_glob 'frames/*.jpg' \\
        --vispr_dir vispr/train --save_dir saved_models

File-backed runs mix UCF101 frame JPEGs and VISPR JPEGs in one pool
(reconstruction_dl.py:20-32). Checkpoints (``<save_dir>/<run_id>/model_*.ckpt``) are
flax msgpack in the JAX package's layout; ``fa_model_state_dict`` loads in either
package's ``load_fa_model``. ``--restart`` resumes from the rolling temp checkpoint.

Synthetic smoke on the CPU (64x64 crops of procedural images, batch 8, float32):
``python -m ted_spad_tpu_torch.train_reconstruction --synthetic --device cpu --epochs 1``.
"""

from __future__ import annotations

import argparse


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", type=str, default=None,
                    help="reference-style params file overlaid on ReconstructionParams")
    ap.add_argument("--run_id", type=str, default=None)
    ap.add_argument("--epochs", type=int, default=None, help="override num_epochs")
    ap.add_argument("--save_dir", type=str, default="saved_models")
    ap.add_argument("--synthetic", action="store_true",
                    help="procedural images at small shapes (no dataset needed)")
    ap.add_argument("--ucf_frames_glob", type=str, default=None)
    ap.add_argument("--vispr_dir", type=str, default=None)
    ap.add_argument("--arch_fa", type=str, default=None, choices=["unet", "unet++"])
    ap.add_argument("--restart", action="store_true", help="resume from the rolling temp checkpoint")
    ap.add_argument("--seed", type=int, default=0, help="data order and augmentation seed")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    return ap


def run(args) -> dict:
    """Train; returns train_reconstruction's summary."""
    import glob

    from ted_spad_tpu_torch.config.params import ReconstructionParams, apply_params_file
    from ted_spad_tpu_torch.data.images import ReconstructionSource
    from ted_spad_tpu_torch.stages.fa_pretraining import train_reconstruction
    from ted_spad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    p = apply_params_file(ReconstructionParams(), args.params)
    if args.run_id:
        p = p.replace(run_id=args.run_id)
    if args.arch_fa:
        p = p.replace(arch_fa=args.arch_fa)
    if args.synthetic:
        p = p.replace(reso_h=64, reso_w=64, batch_size=8, compute_dtype="float32")
        train_src = ReconstructionSource(synthetic_n=64, seed=args.seed)
        val_src = ReconstructionSource(synthetic_n=16, seed=args.seed + 1)
    else:
        paths = sorted(glob.glob(args.ucf_frames_glob)) if args.ucf_frames_glob else []
        if args.vispr_dir:
            paths += sorted(glob.glob(f"{args.vispr_dir}/*.jpg"))
        if not paths:
            raise SystemExit("no images found; pass --ucf_frames_glob / --vispr_dir or --synthetic")
        train_src, val_src = ReconstructionSource(image_paths=paths), None
    res = train_reconstruction(p, train_source=train_src, val_source=val_src,
                               save_dir=args.save_dir, max_epochs=args.epochs,
                               restart=args.restart, seed=args.seed, device=device)
    print(f"done; best: {res['best_path']}")
    return res


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
