"""Clip feature extraction to per-video ``.npy`` files on a CUDA card (counterpart of
scripts/extract_features.py; reference feature_extraction/dali_extraction.py):

    python -m ted_spad_tpu_torch.extract_features --videos_glob 'videos/*/*.mp4' \\
        --saved_model_fa fa.ckpt --saved_model_ft ft.ckpt --out_dir features

decode -> preprocess (K1; K3 with ``--decode_mode yuv``) -> fa -> ft ->
``<out_dir>/<name>.npy`` of (num_clips, F), or (num_clips, ncrops, F) with
``--ncrops 5|10``. ``--quant int8`` runs the W8A8 serving mode (int8 convolutions through
kernel K4, calibrated on the run's first ``--quant_calib_batches`` batches). ``--params FILE`` overlays a
reference-style ``params_*.py`` on ``FeatureExtractionParams`` (``arch_ft``, ``arch_fa``,
``no_ar_distortion``, ``quirk_compat``, ...). ``--shard_id`` / ``--num_shards`` split the
video list round-robin across processes; existing files are skipped (resume).
``--mesh`` under ``torchrun --nproc_per_node=N`` does that split by rank, one process
per card (``cuda:LOCAL_RANK``).

Synthetic smoke on the CPU: ``python -m ted_spad_tpu_torch.extract_features --synthetic --device cpu``
(add ``--decode_mode yuv`` or ``--quant int8`` for those modes).
"""

from __future__ import annotations

import argparse


def run(args) -> dict:
    from ted_spad_tpu_torch.cli import extraction_inputs, maybe_mesh
    from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
    from ted_spad_tpu_torch.stages.feature_extraction import extract_features
    from ted_spad_tpu_torch.utils.device import resolve_device

    mesh = maybe_mesh(args)
    device = resolve_device(args.device if mesh is None else mesh.device)
    p, uris, decode_hw = extraction_inputs(args, n_synthetic=4)
    fa = None
    if p.anonymized:
        fa = load_fa_model(p.arch_fa, seed=p.seed, dtype=p.compute_dtype, device=device,
                           saved_model_file=args.saved_model_fa)
    ft = load_ft_model(p.arch_ft, seed=p.seed, dtype=p.compute_dtype, device=device,
                       saved_model_file=args.saved_model_ft,
                       clip_shape=(p.num_frames, p.reso_h, p.reso_w))
    res = extract_features(p, uris, args.out_dir, fa=fa, ft=ft, batch_size=args.batch,
                           decode_hw=decode_hw, shard_id=args.shard_id,
                           num_shards=args.num_shards, num_workers=args.num_workers,
                           decode_mode=args.decode_mode, device=device, mesh=mesh)
    print(f"done; {res['clips']} clips @ {res['clips_per_sec']:.2f} clips/s"
          + (f"; {len(res['skipped'])} videos skipped (undecodable)" if res["skipped"] else "")
          + (f"; int8 features' cosine to bf16 {res['quant_feature_cossim_vs_bf16']}"
             if "quant_feature_cossim_vs_bf16" in res else ""))
    return res


def parser() -> argparse.ArgumentParser:
    from ted_spad_tpu_torch.cli import add_extraction_args

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_extraction_args(ap)
    ap.add_argument("--out_dir", type=str, default="features")
    ap.add_argument("--shard_id", type=int, default=0)
    ap.add_argument("--num_shards", type=int, default=1)
    return ap


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
