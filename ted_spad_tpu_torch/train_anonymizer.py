"""The adversarial anonymizer training on a CUDA card, TeD-SPAD's core stage
(counterpart of scripts/train_anonymizer.py; reference
anonymization_training/train_anonymizer.py:557-573).

    python -m ted_spad_tpu_torch.train_anonymizer --ucf101_root UCF101 --vispr_root VISPR \
        [--params params_anonymization.py] --save_dir saved_models

``--ucf101_root`` holds ``Videos/``, ``ucfTrainTestlist/{train,test}list01.txt`` and a
class mapping json; ``--vispr_root`` holds ``train2017/`` and ``train_labels.pkl``.
The starting fa, ft and fb come from ``saved_model_{fa,ft,fb}`` in the params file
(checkpoints of either package). The checkpoints written hold the three models in
the JAX package's layout: the fa and ft serve through ``score_video`` /
``extract_features --saved_model_fa/--saved_model_ft``.

Every ft family trains (``arch_ft`` in ``--params``: largei3d, i3d, r3d_18, mvitv2).

Synthetic smoke on the CPU (4 classes, 8x32x32 clips of procedural videos, 16
procedural images, float32; an i3d ft takes its smallest clip, 9x193x193, and the VISPR
images that size too):
``python -m ted_spad_tpu_torch.train_anonymizer --synthetic --device cpu --epochs 1``.

``--mesh`` trains data parallel: ``torchrun --nproc_per_node=N -m ted_spad_tpu_torch.train_anonymizer --mesh ...``
runs one process per card (``cuda:LOCAL_RANK``, NCCL), each step the one-process step
over the global batch; on the CPU add ``--backend gloo --device cpu``.
"""

from __future__ import annotations

import argparse
import os


def parser() -> argparse.ArgumentParser:
    from ted_spad_tpu_torch.cli import add_mesh_args

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", type=str, default=None,
                    help="reference-style params file overlaid on AnonymizationParams")
    ap.add_argument("--run_id", type=str, default=None)
    ap.add_argument("--epochs", type=int, default=None, help="override num_epochs")
    ap.add_argument("--save_dir", type=str, default="saved_models")
    ap.add_argument("--synthetic", action="store_true",
                    help="procedural videos and images at small shapes (no dataset needed)")
    ap.add_argument("--ucf101_root", type=str, default=None)
    ap.add_argument("--class_mapping", type=str, default=None)
    ap.add_argument("--vispr_root", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0, help="data, augmentation and dropout seed")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    add_mesh_args(ap)
    return ap


def run(args) -> dict:
    """Train; returns train_anonymizer's summary."""
    from ted_spad_tpu_torch.cli import synthetic_clip
    from ted_spad_tpu_torch.config.params import AnonymizationParams, apply_params_file
    from ted_spad_tpu_torch.data.images import SyntheticImageSource, VisprImageSource
    from ted_spad_tpu_torch.data.videos import load_ucf101_list, synthetic_video_items
    from ted_spad_tpu_torch.stages.anonymization_training import train_anonymizer
    from ted_spad_tpu_torch.utils.device import resolve_device

    from ted_spad_tpu_torch.cli import maybe_mesh

    mesh = maybe_mesh(args)
    device = resolve_device(args.device if mesh is None else mesh.device)
    p = apply_params_file(AnonymizationParams(), args.params)
    if args.run_id:
        p = p.replace(run_id=args.run_id)
    if args.synthetic:
        t, h, w = synthetic_clip(p.arch_ft)
        p = p.replace(num_classes=4, num_frames=t, reso_h=h, reso_w=w, batch_size=2,
                      batch_size_vispr=4, v_batch_size=2, num_modes=2, compute_dtype="float32",
                      save_acc_threshold=-1.0)
        train_items = synthetic_video_items(8, 4, num_frames=48, h=48, w=64, seed=args.seed)
        val_items = synthetic_video_items(4, 4, num_frames=48, h=48, w=64, seed=args.seed + 1)
        vispr = SyntheticImageSource(n=16, canonical=64, seed=args.seed)
    else:
        if not (args.ucf101_root and args.vispr_root):
            raise SystemExit("pass --ucf101_root and --vispr_root, or --synthetic")
        mapping = args.class_mapping or os.path.join(args.ucf101_root, "class_mapping.json")
        lists = os.path.join(args.ucf101_root, "ucfTrainTestlist")
        videos = os.path.join(args.ucf101_root, "Videos")
        train_items = load_ucf101_list(os.path.join(lists, "trainlist01.txt"), videos, mapping)
        val_items = load_ucf101_list(os.path.join(lists, "testlist01.txt"), videos, mapping)
        vispr = VisprImageSource(os.path.join(args.vispr_root, "train2017"),
                                 os.path.join(args.vispr_root, "train_labels.pkl"))
    res = train_anonymizer(p, train_items=train_items, val_items=val_items, vispr_source=vispr,
                           save_dir=args.save_dir, max_epochs=args.epochs, seed=args.seed,
                           device=device, mesh=mesh)
    print(f"done; best acc {res['best_acc']} at {res['best_path']}")
    return res


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
