"""The TeD-SPAD pipeline end to end on synthetic data (counterpart of
scripts/run_pipeline.py), chained through the on-disk artifacts the reference's stages
exchange (checkpoints and per-video ``.npy`` features):

    python -m ted_spad_tpu_torch.run_pipeline --synthetic [--device cpu]

runs five stages in one process, each reading what the one before it wrote:
  1. fa reconstruction pretraining (L1) -> its best checkpoint;
  2. adversarial anonymization (fa vs fb vs ft), its fa seeded from that checkpoint;
  3. feature extraction through the adversarially trained fa and ft -> ``.npy`` files;
  4. MGFN anomaly training and evaluation on those files -> frame-level ROC AUC;
  5. the privacy attack on images the trained fa anonymizes -> cMAP.
File-backed runs drive each stage's own CLI instead.
"""

from __future__ import annotations

import argparse
import os


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--synthetic", action="store_true",
                    help="procedural videos and images (the only mode of this CLI)")
    ap.add_argument("--epochs", type=int, default=None, help="epochs per stage (default 1)")
    ap.add_argument("--save_dir", type=str, default="saved_models")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    return ap


def run(args) -> dict:
    """The five stages; returns each stage's summary under recon / anon / features /
    mgfn / privacy."""
    if not args.synthetic:
        raise SystemExit("file-backed pipelines run stage scripts individually; use --synthetic here")
    import ted_spad_tpu_torch.data.features as fm
    from ted_spad_tpu_torch.config.params import (
        AnonymizationParams, FeatureExtractionParams, MGFNParams, PrivacyParams,
        ReconstructionParams,
    )
    from ted_spad_tpu_torch.data.images import ReconstructionSource, SyntheticImageSource
    from ted_spad_tpu_torch.data.videos import synthetic_crime_fixture, synthetic_video_items
    from ted_spad_tpu_torch.stages.anomaly_detection import train_anomaly_detection
    from ted_spad_tpu_torch.stages.anonymization_training import train_anonymizer
    from ted_spad_tpu_torch.stages.fa_pretraining import train_reconstruction
    from ted_spad_tpu_torch.stages.feature_extraction import extract_features
    from ted_spad_tpu_torch.stages.privacy_training import train_privacy
    from ted_spad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    save = args.save_dir
    ep = args.epochs or 1

    print("== stage 1/5: fa reconstruction pretraining")
    rp = ReconstructionParams(run_id="pipe_recon", reso_h=32, reso_w=32, batch_size=8,
                              warmup=1, arch_fa="unet++", compute_dtype="float32")
    rec = train_reconstruction(
        rp, train_source=ReconstructionSource(synthetic_n=24, canonical=64),
        val_source=ReconstructionSource(synthetic_n=8, canonical=64, seed=1),
        save_dir=save, max_epochs=ep, seed=args.seed, device=device,
    )

    print("== stage 2/5: adversarial anonymization")
    ano = AnonymizationParams(
        run_id="pipe_anon", num_classes=4, num_frames=8, reso_h=32, reso_w=32,
        batch_size=2, batch_size_vispr=4, v_batch_size=2, num_modes=2,
        compute_dtype="float32", save_acc_threshold=-1.0,
        # Stage 1's checkpoint seeds the fa, as fa_recon.pth does in the reference
        # (params_anonymization.py): the on-disk handoff.
        saved_model_fa=rec["best_path"],
    )
    train_items = synthetic_video_items(8, 4, num_frames=48, h=48, w=64, seed=args.seed)
    val_items = synthetic_video_items(4, 4, num_frames=48, h=48, w=64, seed=args.seed + 1)
    anon = train_anonymizer(
        ano, train_items=train_items, val_items=val_items,
        vispr_source=SyntheticImageSource(n=16, canonical=64),
        save_dir=save, max_epochs=ep, seed=args.seed, device=device,
    )

    print("== stage 3/5: feature extraction with the trained fa")
    fx = FeatureExtractionParams(num_frames=8, reso_h=32, reso_w=32, anonymized=True,
                                 compute_dtype="float32")
    # Abnormal videos come from another procedural class family than normal ones, so
    # MGFN has a feature-level signal to learn.
    uris, gt, abnormal_split = synthetic_crime_fixture(3, 3)
    feats = extract_features(fx, uris, os.path.join(save, "pipe_features"), fa=anon["fa"],
                             ft=anon["ft"], batch_size=4, decode_hw=(48, 64), device=device)
    print(f"   {feats['clips']} clips @ {feats['clips_per_sec']:.2f} clips/s")

    print("== stage 4/5: MGFN anomaly training on extracted features")
    # The gt follows the uris' order; decode order is not fixed, so each file is looked
    # up by its uri. On a re-run into the same save_dir the files come back under
    # 'existing', not 'saved'.
    available = {**feats.get("existing", {}), **feats["saved"]}
    paths = [available[u] for u in uris]
    train_list = os.path.join(save, "pipe_train.list")
    test_list = os.path.join(save, "pipe_test.list")
    for lst in (train_list, test_list):
        with open(lst, "w") as f:
            f.write("\n".join(paths) + "\n")
    mp = MGFNParams(
        rgb_list=train_list, test_rgb_list=test_list, feature_size=2048,
        dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16, batch_size=3,
        dropout_rate=0.3, model_name="pipe_mgfn",
    )
    old_split = fm.ABNORMAL_SPLIT["UCF"]
    fm.ABNORMAL_SPLIT["UCF"] = abnormal_split
    try:
        mg = train_anomaly_detection(mp, save_dir=save, gt=gt, max_epochs=max(ep, 2),
                                     shuffle=True, device=device)
    finally:
        fm.ABNORMAL_SPLIT["UCF"] = old_split

    print("== stage 5/5: privacy attack on anonymized images")
    pp = PrivacyParams(run_id="pipe_priv", reso_h=32, reso_w=32, batch_size=8,
                       v_batch_size=8, anon=True, compute_dtype="float32", warmup=1)
    priv = train_privacy(
        pp, train_source=SyntheticImageSource(n=24, canonical=64),
        val_source=SyntheticImageSource(n=16, canonical=64, seed=1),
        save_dir=save, fa_model=anon["fa"], max_epochs=ep, seed=args.seed, device=device,
    )

    nan = float("nan")
    print("\n== pipeline summary")
    print(f"  recon best L1:        {min(rec['history']['val_loss'] or [nan]):.4f}")
    print(f"  anonymizer utility:   {(anon['history']['val_acc'] or [nan])[-1]:.4f} top-1")
    print(f"  extraction:           {feats['clips']} clips, {feats['clips_per_sec']:.2f} clips/s")
    print(f"  anomaly ROC AUC:      {max(mg['history']['test_AUC']):.4f}")
    print(f"  privacy cMAP (anon):  {priv['best_cmap']:.4f} (lower = better privacy)")
    return {"recon": rec, "anon": anon, "features": feats, "mgfn": mg, "privacy": priv}


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
