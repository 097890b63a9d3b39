"""Convert the reference's torch seed files into the port's checkpoints (counterpart of
scripts/convert_weights.py):

  - ``i3d_r50_kinetics.pth``   -> largei3d ft seed (model_loaders.py:185-197)
  - ``rgb_imagenet.pt``        -> i3d ft seed (model_loaders.py:171-182)
  - torchvision resnet50 ImageNet -> fb predictor seed (model_loaders.py:157-168)
  - torchvision resnet18 ImageNet -> UNet++ fa encoder seed (smp encoder_weights,
    model_loaders.py:18-30); smp's resnet18 encoder shares torchvision's state_dict
  - torchvision ``r3d_18(weights='DEFAULT')``    -> ft seed (model_loaders.py:203-204)
  - torchvision ``mvit_v2_s(weights='DEFAULT')`` -> ft seed (model_loaders.py:219-221)

    python -m ted_spad_tpu_torch.convert_weights --kind largei3d --src i3d_r50_kinetics.pth \\
        --out seeds/ft_largei3d.ckpt --num_classes 102

The file is flax msgpack in the JAX package's layout (``{fa,ft,fb}_model_state_dict``):
``load_*_model(saved_model_file=)`` of either package reads it, and the stages take it
as ``saved_model*``. The template the converted weights go into is the port's seeded
model built on ``--device`` (default cuda; ``--device cpu`` on a machine without one).
"""

from __future__ import annotations

import argparse


def parser() -> argparse.ArgumentParser:
    from ted_spad_tpu_torch.utils.torch_convert import SEED_KINDS

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kind", required=True, choices=SEED_KINDS)
    ap.add_argument("--src", required=True, help="torch .pth/.pt (or .npz) checkpoint")
    ap.add_argument("--out", required=True, help="output .ckpt path")
    ap.add_argument("--num_classes", type=int, default=102)
    ap.add_argument("--num_pa", type=int, default=7)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the template model (default cuda)")
    return ap


def run(args) -> str:
    from ted_spad_tpu_torch.utils.checkpoint import save_checkpoint
    from ted_spad_tpu_torch.utils.torch_convert import convert_seed_payload, load_torch_checkpoint

    sd = load_torch_checkpoint(args.src)
    payload = convert_seed_payload(args.kind, sd, num_classes=args.num_classes,
                                   num_pa=args.num_pa, device=args.device)
    save_checkpoint(args.out, payload)
    print(f"wrote {args.out}")
    return args.out


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
