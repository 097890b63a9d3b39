"""Privacy-attack evaluation on a CUDA card (counterpart of scripts/train_privacy.py;
reference privacy_training/train_privacy.py): a fresh ResNet-50 attacker trained on
VISPR, plain or through a frozen anonymizer, scored by cMAP.

    python -m ted_spad_tpu_torch.train_privacy --vispr_root VISPR --save_dir saved_models
    python -m ted_spad_tpu_torch.train_privacy --vispr_root VISPR --anon --saved_model_fa CKPT

``--vispr_root`` holds ``{train,test}2017/`` jpg folders and ``{train,test}_labels.pkl``
(aux_code/config.py's layout). ``--anon --saved_model_fa CKPT`` trains on images the fa
of a checkpoint of either package (fa pretraining or the adversarial stage) anonymized;
``--fa_arch unet`` reads a plain-UNet fa, whose DoubleConvs run through kernel K2.
Checkpoints are flax msgpack in the JAX package's layout (``fb_model_state_dict``).

Synthetic smoke on the CPU (64^2 images of procedural stripes, float32):
``python -m ted_spad_tpu_torch.train_privacy --synthetic --device cpu --epochs 1 [--anon]``.
"""

from __future__ import annotations

import argparse
import os


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", type=str, default=None,
                    help="reference-style params file overlaid on PrivacyParams")
    ap.add_argument("--run_id", type=str, default=None)
    ap.add_argument("--epochs", type=int, default=None, help="override num_epochs")
    ap.add_argument("--save_dir", type=str, default="saved_models")
    ap.add_argument("--synthetic", action="store_true",
                    help="procedural images at small shapes (no dataset needed)")
    ap.add_argument("--vispr_root", type=str, default=None)
    ap.add_argument("--anon", action="store_true", help="train on fa-anonymized images")
    ap.add_argument("--saved_model_fa", type=str, default=None)
    ap.add_argument("--fa_arch", type=str, default="unet++", choices=["unet++", "unet"])
    ap.add_argument("--seed", type=int, default=0, help="data and augmentation seed")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    return ap


def run(args) -> dict:
    """Train; returns train_privacy's summary."""
    from ted_spad_tpu_torch.config.params import PrivacyParams, apply_params_file
    from ted_spad_tpu_torch.data.images import SyntheticImageSource, VisprImageSource
    from ted_spad_tpu_torch.stages.privacy_training import train_privacy
    from ted_spad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    p = apply_params_file(PrivacyParams(), args.params)
    if args.run_id:
        p = p.replace(run_id=args.run_id)
    if args.anon:
        p = p.replace(anon=True)
        if args.saved_model_fa:
            p = p.replace(saved_model=args.saved_model_fa)
    if args.synthetic:
        p = p.replace(reso_h=64, reso_w=64, batch_size=8, v_batch_size=8, compute_dtype="float32")
        train_src = SyntheticImageSource(n=64, num_pa=p.num_pa, seed=args.seed)
        val_src = SyntheticImageSource(n=32, num_pa=p.num_pa, seed=args.seed + 1)
    else:
        if not args.vispr_root:
            raise SystemExit("pass --vispr_root or --synthetic")
        root = args.vispr_root
        train_src = VisprImageSource(os.path.join(root, "train2017"), os.path.join(root, "train_labels.pkl"))
        val_src = VisprImageSource(os.path.join(root, "test2017"), os.path.join(root, "test_labels.pkl"),
                                   shuffle=False)
    res = train_privacy(p, train_source=train_src, val_source=val_src, save_dir=args.save_dir,
                        fa_arch=args.fa_arch, max_epochs=args.epochs, seed=args.seed, device=device)
    print(f"done; best cMAP {res['best_cmap']:.4f} at {res['best_path']}")
    return res


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
