"""Action (ft) training on a CUDA card (counterpart of scripts/train_action.py;
reference action_training/train_action.py and, with ``--anonymized``,
train_anonymized_action.py).

    python -m ted_spad_tpu_torch.train_action --ucf101_root UCF101 --save_dir saved_models

``--ucf101_root`` holds ``Videos/``, ``ucfTrainTestlist/{train,test}list01.txt`` and a
class mapping json. ``--anonymized --saved_model_fa CKPT`` trains through a frozen fa
(a checkpoint of either package's fa pretraining). Checkpoints are flax msgpack in the
JAX package's layout; ``ft_model_state_dict`` loads in either package's
``load_ft_model`` and serves through the extraction stage.

Every ft family trains (``--arch`` or ``arch`` in ``--params``: largei3d, i3d, r3d_18,
mvitv2).

Synthetic smoke on the CPU (4 classes, 8x32x32 clips of procedural videos, float32; an
i3d ft takes its smallest clip, 9x193x193):
``python -m ted_spad_tpu_torch.train_action --synthetic --device cpu --epochs 1 [--arch r3d_18]``.
"""

from __future__ import annotations

import argparse
import os


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", type=str, default=None,
                    help="reference-style params file overlaid on ActionParams")
    ap.add_argument("--run_id", type=str, default=None)
    ap.add_argument("--epochs", type=int, default=None, help="override num_epochs")
    ap.add_argument("--save_dir", type=str, default="saved_models")
    ap.add_argument("--synthetic", action="store_true",
                    help="procedural videos at small shapes (no dataset needed)")
    ap.add_argument("--ucf101_root", type=str, default=None)
    ap.add_argument("--class_mapping", type=str, default=None)
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--anonymized", action="store_true")
    ap.add_argument("--saved_model_fa", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0, help="data, augmentation and dropout seed")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    return ap


def run(args) -> dict:
    """Train; returns train_action's summary."""
    from ted_spad_tpu_torch.cli import synthetic_clip
    from ted_spad_tpu_torch.config.params import ActionParams, apply_params_file
    from ted_spad_tpu_torch.data.videos import load_ucf101_list, synthetic_video_items
    from ted_spad_tpu_torch.stages.action_training import train_action
    from ted_spad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    p = apply_params_file(ActionParams(), args.params)
    if args.run_id:
        p = p.replace(run_id=args.run_id)
    if args.arch:
        p = p.replace(arch=args.arch)
    if args.anonymized:
        p = p.replace(anonymized=True, saved_model_fa=args.saved_model_fa)
    if args.synthetic:
        t, h, w = synthetic_clip(p.arch)
        p = p.replace(num_classes=4, num_frames=t, reso_h=h, reso_w=w, batch_size=4,
                      v_batch_size=4, num_modes=2, compute_dtype="float32")
        train_items = synthetic_video_items(16, 4, num_frames=48, h=48, w=64, seed=args.seed)
        val_items = synthetic_video_items(8, 4, num_frames=48, h=48, w=64, seed=args.seed + 1)
    else:
        if not args.ucf101_root:
            raise SystemExit("pass --ucf101_root or --synthetic")
        mapping = args.class_mapping or os.path.join(args.ucf101_root, "class_mapping.json")
        lists = os.path.join(args.ucf101_root, "ucfTrainTestlist")
        videos = os.path.join(args.ucf101_root, "Videos")
        train_items = load_ucf101_list(os.path.join(lists, "trainlist01.txt"), videos, mapping)
        val_items = load_ucf101_list(os.path.join(lists, "testlist01.txt"), videos, mapping)
    res = train_action(p, train_items=train_items, val_items=val_items, save_dir=args.save_dir,
                       max_epochs=args.epochs, seed=args.seed, device=device)
    print(f"done; best acc {res['best_acc']} at {res['best_path']}")
    return res


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
