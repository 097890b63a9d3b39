"""MGFN anomaly-detection training and evaluation on a CUDA card (counterpart of
scripts/train_mgfn.py; reference anomaly_detection_mgfn/main.py and test.py).

    python -m ted_spad_tpu_torch.train_mgfn --datasetname UCF \\
        --rgb_list data/ucf-i3d.list --test_rgb_list data/ucf-i3d-test.list \\
        --gt data/gt-ucf.npy --save_dir saved_models

``--datasetname`` applies the preset of option.py:33-58 (lists, gt, model name,
1024-d features for XD, 16 frames per clip for ST); ``--params FILE`` and the
explicit list and gt flags override it. Checkpoints (``<model_name>_<epoch>_best_
<metric>.ckpt``, ``<model_name>_final.ckpt``) are flax msgpack in the JAX package's
layout. ``--test_only CKPT`` evaluates a checkpoint written by either package.

Synthetic smoke on the CPU (small widths, feature files in a temporary directory):
``python -m ted_spad_tpu_torch.train_mgfn --synthetic --device cpu --epochs 2``.

``--mesh`` trains data parallel: ``torchrun --nproc_per_node=N -m ted_spad_tpu_torch.train_mgfn --mesh ...``
runs one process per card (``cuda:LOCAL_RANK``, NCCL), each step the one-process step
over the global batch; on the CPU add ``--backend gloo --device cpu``.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np


def write_synthetic_features(root: str, *, n_train: int, n_test: int, feature_size: int,
                             clips: tuple[int, int], frames_per_clip: int, seed: int):
    """Feature files of a synthetic dataset under ``root``: ``n_train`` training
    videos (the first half abnormal, each with a planted high-magnitude span of 4
    clips) and ``n_test`` test videos (every other one with such a span). Returns
    (train list, test list, frame-level gt)."""
    rng = np.random.default_rng(seed)
    train_paths, test_paths, gts = [], [], []
    for i in range(n_train):
        t = int(rng.integers(*clips))
        x = rng.normal(0, 1, (t, feature_size)).astype(np.float32)
        if i < n_train // 2:
            s = int(rng.integers(0, t - 4))
            x[s:s + 4] *= 6.0
        path = f"{root}/{'a' if i < n_train // 2 else 'n'}{i}.npy"
        np.save(path, x)
        train_paths.append(path)
    for i in range(n_test):
        t = int(rng.integers(*clips))
        x = rng.normal(0, 1, (t, feature_size)).astype(np.float32)
        m = np.zeros(t, bool)
        if i % 2 == 0:
            s = int(rng.integers(0, t - 4))
            x[s:s + 4] *= 6.0
            m[s:s + 4] = True
        path = f"{root}/t{i}.npy"
        np.save(path, x)
        test_paths.append(path)
        gts.append(np.repeat(m.astype(np.float32), frames_per_clip))
    with open(f"{root}/train.list", "w") as f:
        f.write("\n".join(train_paths) + "\n")
    with open(f"{root}/test.list", "w") as f:
        f.write("\n".join(test_paths) + "\n")
    return f"{root}/train.list", f"{root}/test.list", np.concatenate(gts)


def parser() -> argparse.ArgumentParser:
    from ted_spad_tpu_torch.cli import add_mesh_args

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", type=str, default=None,
                    help="reference-style params_*.py overlaid on MGFNParams")
    ap.add_argument("--datasetname", type=str, default="UCF", choices=["UCF", "ST", "XD"])
    ap.add_argument("--rgb_list", type=str, default=None)
    ap.add_argument("--test_rgb_list", type=str, default=None)
    ap.add_argument("--gt", type=str, default=None)
    ap.add_argument("--epochs", type=int, default=None, help="override max_epoch")
    ap.add_argument("--save_dir", type=str, default="saved_models")
    ap.add_argument("--test_only", type=str, default=None, help="checkpoint to evaluate")
    ap.add_argument("--shuffle", action="store_true")
    ap.add_argument("--synthetic", action="store_true",
                    help="small model on synthetic feature files (no dataset needed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    add_mesh_args(ap)
    return ap


def run(args) -> dict:
    """Train (or, with ``--test_only``, evaluate); returns train_anomaly_detection's summary or
    ``{"roc_auc", "pr_auc"}``."""
    import ted_spad_tpu_torch.data.features as fm
    from ted_spad_tpu_torch.config.params import MGFNParams, apply_params_file
    from ted_spad_tpu_torch.utils.device import resolve_device

    from ted_spad_tpu_torch.cli import maybe_mesh

    mesh = maybe_mesh(args)
    device = resolve_device(args.device if mesh is None else mesh.device)
    p = apply_params_file(MGFNParams.for_dataset(args.datasetname, seed=args.seed), args.params)
    gt = None
    if args.synthetic:
        root = tempfile.mkdtemp()
        train_list, test_list, gt = write_synthetic_features(
            root, n_train=16, n_test=6, feature_size=64, clips=(40, 80),
            frames_per_clip=p.frames_per_clip, seed=args.seed)
        fm.ABNORMAL_SPLIT[p.datasetname] = 8
        p = p.replace(rgb_list=train_list, test_rgb_list=test_list, feature_size=64,
                      dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16, batch_size=4,
                      dropout_rate=0.3, model_name="mgfn_synth")
    else:
        for field in ("rgb_list", "test_rgb_list", "gt"):
            if getattr(args, field):
                p = p.replace(**{field: getattr(args, field)})

    if args.test_only:
        from ted_spad_tpu_torch.data.features import TestFeatureDataset
        from ted_spad_tpu_torch.models import load_mgfn_model
        from ted_spad_tpu_torch.stages.anomaly_detection import evaluate, make_score_fn

        model = load_mgfn_model(p, saved_model_file=args.test_only, device=device)
        eval_batch = 8 if mesh is None else max(8 // mesh.world_size, 1) * mesh.world_size
        roc, pr = evaluate(make_score_fn(model, device=device, mesh=mesh),
                           TestFeatureDataset(p.test_rgb_list, p.datasetname),
                           gt if gt is not None else np.load(p.gt), eval_batch=eval_batch,
                           frames_per_clip=p.frames_per_clip)
        print(f"roc_auc {roc:.4f} pr_auc {pr:.4f}")
        return {"roc_auc": roc, "pr_auc": pr}

    from ted_spad_tpu_torch.stages.anomaly_detection import train_anomaly_detection

    res = train_anomaly_detection(p, save_dir=args.save_dir, gt=gt, max_epochs=args.epochs,
                                  shuffle=args.shuffle, device=device, mesh=mesh)
    print(f"done; best {res['best_metric']:.4f} at {res['best_path']}")
    return res


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
