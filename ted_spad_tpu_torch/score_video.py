"""One-command anomaly scoring of raw videos on a CUDA card:
decode -> preprocess (K1; K3 with ``--decode_mode yuv``) -> fa -> ft -> .npy features ->
MGFN frame scores. ``--quant int8`` extracts in the W8A8 serving mode (kernel K4).

    python -m ted_spad_tpu_torch.score_video --videos_glob 'cam/*.mp4' \\
        --fa_weights fa.npz --ft_weights ft.npz --mgfn_weights mgfn.npz --out_dir scores

Counterpart of scripts/score_video.py. Per video it writes
``<out_dir>/scores/<name>.npy``, frame-level anomaly scores in [0, 1] on the
video's real frame timeline, and prints one JSON line with the score summary and
the ``--threshold`` exceedance spans. Clip features land in
``<out_dir>/features/<confighash>/``, keyed on the extraction configuration, so a
re-run with other settings never reuses stale features while a same-config re-run
resumes.

Configuration: ``--params FILE`` overlays a reference-style ``params_*.py`` file on
``FeatureExtractionParams`` (e.g. ``arch_fa = "unet"`` selects the plain UNet fa,
whose DoubleConvs run kernel K2; ``arch_ft = "i3d"`` the InceptionI3d ft, whose 1024-d
features ``--datasetname XD`` takes). The features' width must be the MGFN preset's.

Weights: ``--saved_model_fa`` / ``--saved_model_ft`` / ``--mgfn_ckpt`` take the
checkpoints the JAX package's stages write (flax msgpack, read under
``fa_/ft_/mgfn_model_state_dict``; ``python -m ted_spad_tpu_torch.train_mgfn`` writes
the MGFN one too), ``--*_weights`` take ``.npz`` files of flax variables keyed by
'/'-joined paths (utils/jax_weights.load_npz_variables); without either the models
draw random weights from ``--seed`` (smoke runs only).

``--mesh`` under ``torchrun --nproc_per_node=N`` spreads the videos over one process per
card: each extracts and scores its share, and rank 0 writes ``summary.json``.

Synthetic smoke on the CPU: ``python -m ted_spad_tpu_torch.score_video --synthetic --device cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np


def spans_above(frame_scores, threshold: float) -> list[list[int]]:
    """[start, end) frame spans where the score exceeds threshold."""
    above = np.asarray(frame_scores) > threshold
    if above.size == 0:
        return []
    edges = np.flatnonzero(np.diff(above.astype(np.int8)))
    starts = list(edges[~above[edges]] + 1)
    ends = list(edges[above[edges]] + 1)
    if above[0]:
        starts.insert(0, 0)
    if above[-1]:
        ends.append(len(above))
    return [[int(s), int(e)] for s, e in zip(starts, ends)]  # plain ints: JSON-safe


def run(args) -> list[dict]:
    """Score every video; returns the per-video summaries (also written to
    ``<out_dir>/summary.json``)."""
    from ted_spad_tpu_torch.cli import extraction_inputs, maybe_mesh
    from ted_spad_tpu_torch.config.params import MGFNParams
    from ted_spad_tpu_torch.data.features import padded_test_batch
    from ted_spad_tpu_torch.data.video_reader import open_video
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model, load_mgfn_model
    from ted_spad_tpu_torch.ops.metrics import frame_level_scores
    from ted_spad_tpu_torch.ops.temporal import test_features
    from ted_spad_tpu_torch.stages.anomaly_detection import make_score_fn
    from ted_spad_tpu_torch.stages.feature_extraction import extract_features
    from ted_spad_tpu_torch.utils.device import resolve_device
    from ted_spad_tpu_torch.utils.jax_weights import (
        FT_HEADS, load_jax_variables, load_npz_variables,
    )

    mesh = maybe_mesh(args)
    device = resolve_device(args.device if mesh is None else mesh.device)
    p, uris, decode_hw = extraction_inputs(args, n_synthetic=2)
    mp = MGFNParams.for_dataset(args.datasetname, seed=args.seed)
    if args.synthetic:  # MGFN's internal dims shrink too
        mp = mp.replace(dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16)

    # p's repr carries the quant settings: int8 and bf16 features never share an entry.
    cfg = (f"{p!r}|{args.decode_mode}|{decode_hw}|params={args.params}|fa={args.fa_weights}"
           f"|ft={args.ft_weights}|fa_ckpt={args.saved_model_fa}|ft_ckpt={args.saved_model_ft}")
    feat_dir = os.path.join(args.out_dir, "features", hashlib.sha1(cfg.encode()).hexdigest()[:12])
    score_dir = os.path.join(args.out_dir, "scores")
    os.makedirs(feat_dir, exist_ok=True)
    os.makedirs(score_dir, exist_ok=True)
    if mesh is None or mesh.rank == 0:
        with open(os.path.join(feat_dir, "_extract_config.txt"), "w") as f:
            f.write(cfg + "\n")

    fa = None
    if p.anonymized:
        fa = load_fa_model(p.arch_fa, seed=p.seed, dtype=p.compute_dtype, device=device,
                           saved_model_file=args.saved_model_fa)
        if args.fa_weights:
            load_jax_variables(fa, load_npz_variables(args.fa_weights))
    ft = load_ft_model(p.arch_ft, seed=p.seed, dtype=p.compute_dtype, device=device,
                       saved_model_file=args.saved_model_ft,
                       clip_shape=(p.num_frames, p.reso_h, p.reso_w))
    if args.ft_weights:
        load_jax_variables(ft, load_npz_variables(args.ft_weights), skip=FT_HEADS)
    res = extract_features(p, uris, feat_dir, fa=fa, ft=ft, batch_size=args.batch,
                           decode_hw=decode_hw, num_workers=args.num_workers,
                           decode_mode=args.decode_mode, device=device, mesh=mesh)
    feat_paths = {**res["existing"], **res["saved"]}

    model = load_mgfn_model(mp, saved_model_file=args.mgfn_ckpt, device=device)
    if args.mgfn_weights:
        load_jax_variables(model, load_npz_variables(args.mgfn_weights))
    score_fn = make_score_fn(model, device=device)
    summaries = []
    # Under --mesh each rank scores its shard of the videos; rank 0 writes the summary.
    for uri in (uris if mesh is None else uris[mesh.rank::mesh.world_size]):
        if uri not in feat_paths:
            summaries.append({"video": uri, "error": res["skipped"].get(uri, "no features")})
            print(json.dumps(summaries[-1]))
            continue
        raw_feats = np.load(feat_paths[uri])  # (T, F) or (T, ncrops, F)
        if raw_feats.shape[-1] != mp.feature_size:
            raise SystemExit(
                f"extracted features are {raw_feats.shape[-1]}-d but the "
                f"--datasetname {args.datasetname} MGFN preset (and its checkpoint) "
                f"expects {mp.feature_size}-d — match the extractor to the "
                f"checkpoint (e.g. XD's 1024-d presets need an i3d ft: pass a "
                f"--params file with arch_ft='i3d')"
            )
        video, mask, t = padded_test_batch(test_features(raw_feats))
        clip_scores = score_fn(video, mask)[0, :t].cpu().numpy()
        # Expand to the real frame timeline: each clip window covers p.clip_step
        # decoded frames; the ratio redistribution absorbs the tail.
        try:
            vr = open_video(uri, decode_hw[1], decode_hw[0])
            n_frames = len(vr)
            vr.close()
        except (OSError, RuntimeError):  # header re-read is best-effort
            n_frames = t * p.clip_step
        frames = frame_level_scores(clip_scores, n_frames, frames_per_clip=p.clip_step)
        out = os.path.join(score_dir, os.path.basename(feat_paths[uri]))
        np.save(out, frames)
        summaries.append({
            "video": uri,
            "scores": out,
            "clips": int(t),
            "frames": int(len(frames)),
            "max_score": round(float(frames.max()), 4),
            "mean_score": round(float(frames.mean()), 4),
            "spans_above_threshold": spans_above(frames, args.threshold),
        })
        print(json.dumps(summaries[-1]))
    if mesh is not None:
        by_uri = {s["video"]: s for part in mesh.exchange(summaries) for s in part}
        summaries = [by_uri[u] for u in uris]
        if mesh.rank != 0:
            return summaries
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump({"threshold": args.threshold, "videos": summaries}, f, indent=1)
    return summaries


def parser() -> argparse.ArgumentParser:
    from ted_spad_tpu_torch.cli import add_extraction_args

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_extraction_args(ap)
    ap.add_argument("--mgfn_ckpt", type=str, default=None,
                    help="trained MGFN checkpoint (mgfn_model_state_dict)")
    ap.add_argument("--fa_weights", type=str, default=None, help="fa variables (.npz)")
    ap.add_argument("--ft_weights", type=str, default=None, help="ft variables (.npz)")
    ap.add_argument("--mgfn_weights", type=str, default=None, help="MGFN variables (.npz)")
    ap.add_argument("--datasetname", type=str, default="UCF", choices=["UCF", "ST", "XD"],
                    help="MGFN preset the weights were trained with")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="frame-score threshold for the reported anomaly spans")
    ap.add_argument("--out_dir", type=str, default="scores_out")
    return ap


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
