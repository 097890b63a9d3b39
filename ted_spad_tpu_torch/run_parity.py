"""One-command parity harness against the paper's headline numbers (counterpart of
scripts/run_parity.py): seed conversion -> the training stages, configured by the
reference's own params files -> the raw-vs-anonymized delta report (VISPR cMAP,
frame-level ROC AUC).

Targets (reference README.md:11): cMAP change after anonymization -32.25% (relative),
UCF-Crime frame AUC cost -3.69 points (absolute).

Dry run (no datasets, no seed files: the whole chain on synthetic data, with the seed
state_dicts drawn by ``utils/reference_layout.py`` in the published files' layout and
converted through the production converter path):

    python -m ted_spad_tpu_torch.run_parity --dry-run [--tiny] [--device cpu]

Real data (the seeds are the reference's published files in ``--seeds_dir``):

    python -m ted_spad_tpu_torch.run_parity \\
        --seeds_dir saved_models \\
        --ucf101_train_list ucf101/trainlist01.txt --ucf101_val_list ucf101/testlist01.txt \\
        --ucf101_videos ucf101/videos --vispr_train vispr --vispr_test vispr_test \\
        --crime_glob 'UCF_Crimes/Train/*/*.mp4' \\
        --crime_test_glob 'UCF_Crimes/Test/*/*.mp4' --crime_gt gt-parity.npy \\
        --params_dir REFERENCE_CHECKOUT

The MGFN AUC is scored on ``--crime_test_glob`` (the reference's held-out test split);
``--crime_gt`` holds frame labels concatenated in the test-video order the run writes to
``<save_dir>/parity_crime_order.txt`` (build it with ``python -m ted_spad_tpu_torch.make_gt``
over that list; its length is checked against the extracted clip counts before scoring).

Stage order follows the reference workflow (README.md:54-92): ft action training -> fa
reconstruction pretraining -> adversarial anonymization -> privacy attack raw and
anonymized -> feature extraction raw and anonymized -> MGFN raw and anonymized -> delta
report (``<save_dir>/parity_report.json``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

BASELINE_CMAP_DELTA_PCT = -32.25  # README.md:11
BASELINE_AUC_DELTA_PTS = -3.69  # README.md:11

# Each stage's params file in a reference checkout.
REF_PARAMS = {
    "action": "action_training/params_action.py",
    "recon": "fa_pretraining/parameters.py",
    "anon": "anonymization_training/params_anonymization.py",
    "privacy": "privacy_training/params_privacy.py",
    "extract": "feature_extraction/params_feature_ex.py",
}

REAL_DATA_ARGS = ["ucf101_train_list", "ucf101_val_list", "ucf101_videos", "vispr_train",
                  "vispr_test", "crime_glob", "crime_gt"]


def _maybe_overlay(params, params_dir: str | None, key: str):
    """Overlay the reference's params file for ``key`` where ``params_dir`` holds it;
    the defaults otherwise."""
    from ted_spad_tpu_torch.config.params import apply_params_file

    if not params_dir:
        return params
    path = os.path.join(params_dir, REF_PARAMS[key])
    return apply_params_file(params, path) if os.path.exists(path) else params


def convert_seeds(seed_srcs: dict[str, str], out_dir: str, num_classes: int, log,
                  device: str = "cuda") -> dict[str, str]:
    """Convert the three seeds the pipeline consumes (ft largei3d: Kinetics; fa UNet++
    encoder: ImageNet r18; fb predictor: ImageNet r50) through ``convert_seed_payload``,
    the function ``convert_weights`` runs, into ``out_dir``. Returns {slot: path}."""
    from ted_spad_tpu_torch.utils.checkpoint import save_checkpoint
    from ted_spad_tpu_torch.utils.torch_convert import convert_seed_payload, load_torch_checkpoint

    os.makedirs(out_dir, exist_ok=True)
    names = {"largei3d": "ft", "unet++": "fa", "r50": "fb"}
    files = {"largei3d": "ft_largei3d_seed.ckpt", "unet++": "fa_unetpp_seed.ckpt",
             "r50": "fb_r50_seed.ckpt"}
    paths = {}
    for kind, slot in names.items():
        if kind not in seed_srcs:
            continue
        payload = convert_seed_payload(kind, load_torch_checkpoint(seed_srcs[kind]),
                                       num_classes=num_classes, clip_shape=(8, 32, 32),
                                       device=device)
        paths[slot] = save_checkpoint(os.path.join(out_dir, files[kind]), payload)
    log(f"converted seeds: {sorted(paths)}")
    return paths


def mgfn_lists(branch: str, feats: dict, extract_uris: list[str], crime_uris: list[str],
               test_uris: list[str], crime_gt, save: str) -> tuple[str, str]:
    """Write the MGFN train and test lists of one branch; returns their paths. The gt
    is per-video frame labels concatenated in test order, so the test list must stay
    aligned with it: a video with no features (skipped or failed) would shift every
    later video's labels, and a gt not of 32 frames per extracted clip (test.py's x32
    repeat) would be rescaled by the scorer's length-ratio fallback into a plausible
    wrong AUC. Both raise RuntimeError."""
    import numpy as np

    available = {**feats.get("existing", {}), **feats["saved"]}
    missing = [u for u in extract_uris if u not in available]
    if missing:
        raise RuntimeError(
            f"{branch}: {len(missing)} video(s) have no features (skipped or "
            f"failed: {missing[:3]}...) — gt alignment would break; fix or "
            "drop them from BOTH the video list and the gt before scoring"
        )
    train_paths = [available[u] for u in crime_uris]
    test_paths = [available[u] for u in test_uris]
    total_clips = sum(int(np.load(p, mmap_mode="r").shape[0]) for p in test_paths)
    if len(crime_gt) != total_clips * 32:
        raise RuntimeError(
            f"{branch}: gt has {len(crime_gt)} frames but the test features "
            f"cover {total_clips} clips = {total_clips * 32} frames — the gt "
            "was not built for this video list/order; rebuild it with "
            "make_gt over parity_crime_order.txt"
        )
    lst = os.path.join(save, f"parity_{branch}.list")
    tlst = os.path.join(save, f"parity_{branch}_test.list")
    for path, rows in ((lst, train_paths), (tlst, test_paths)):
        with open(path, "w") as f:
            f.write("\n".join(rows) + "\n")
    return lst, tlst


def run_parity(args, log=print) -> dict:
    """The harness; returns the report (``parity_report.json``'s keys) with, not written
    to the file, each stage's wall time in seconds under ``stage_seconds`` and under
    ``sizes`` the run's data sizes, the batch sizes its stages were given and the clips
    each extraction read."""
    import numpy as np

    import ted_spad_tpu_torch.data.features as fm
    from ted_spad_tpu_torch.config.params import (
        ActionParams, AnonymizationParams, FeatureExtractionParams, MGFNParams, PrivacyParams,
        ReconstructionParams,
    )
    from ted_spad_tpu_torch.stages.action_training import train_action
    from ted_spad_tpu_torch.stages.anomaly_detection import train_anomaly_detection
    from ted_spad_tpu_torch.stages.anonymization_training import train_anonymizer
    from ted_spad_tpu_torch.stages.fa_pretraining import train_reconstruction
    from ted_spad_tpu_torch.stages.feature_extraction import extract_features
    from ted_spad_tpu_torch.stages.privacy_training import train_privacy
    from ted_spad_tpu_torch.utils.device import resolve_device, torch_dtype

    device = resolve_device(args.device)
    save = args.save_dir
    os.makedirs(save, exist_ok=True)
    dry = args.dry_run
    ep = args.epochs
    seconds: dict[str, float] = {}
    clock = [time.perf_counter()]

    def lap(stage: str) -> None:
        now = time.perf_counter()
        seconds[stage] = now - clock[0]
        clock[0] = now

    # ---- phase 0: seeds -----------------------------------------------------------
    from ted_spad_tpu_torch.utils.reference_layout import SEED_FILES, write_dry_run_seeds

    if dry:
        seed_srcs = write_dry_run_seeds(os.path.join(save, "seed_sources"), seed=args.seed)
    else:
        seed_srcs = {}
        for kind, fname in SEED_FILES.items():
            path = os.path.join(args.seeds_dir or "saved_models", fname)
            if os.path.exists(path):
                seed_srcs[kind] = path
            else:
                log(f"WARNING: seed {path} missing — {kind} starts from random init")
    num_classes = 4 if dry else 102
    seeds = convert_seeds(seed_srcs, os.path.join(save, "seeds"), num_classes, log, device)
    lap("seeds")

    # ---- data ---------------------------------------------------------------------
    if dry:
        from ted_spad_tpu_torch.data.images import ReconstructionSource, SyntheticImageSource
        from ted_spad_tpu_torch.data.videos import synthetic_crime_fixture, synthetic_video_items

        tiny = args.tiny
        nv = 4 if tiny else 8
        train_items = synthetic_video_items(nv, 4, num_frames=48, h=48, w=64, seed=args.seed)
        val_items = synthetic_video_items(max(nv // 2, 2), 4, num_frames=48, h=48, w=64,
                                          seed=args.seed + 1)
        vispr_train = SyntheticImageSource(n=8 if tiny else 16, canonical=64)
        vispr_test = SyntheticImageSource(n=8 if tiny else 16, canonical=64, seed=1)
        recon_train = ReconstructionSource(synthetic_n=8 if tiny else 16, canonical=64)
        recon_val = ReconstructionSource(synthetic_n=8, canonical=64, seed=1)
        nfam = 2 if tiny else 3
        crime_uris, crime_gt, abnormal_split = synthetic_crime_fixture(nfam, nfam)
        test_uris = crime_uris  # synthetic: a plumbing check, train == test by design
        decode_hw = (48, 64)
        shape_kw = dict(num_frames=8, reso_h=32, reso_w=32, compute_dtype="float32")
    else:
        from ted_spad_tpu_torch.data.images import ReconstructionSource, VisprImageSource
        from ted_spad_tpu_torch.data.videos import load_ucf101_list

        train_items = load_ucf101_list(args.ucf101_train_list, args.ucf101_videos)
        val_items = load_ucf101_list(args.ucf101_val_list, args.ucf101_videos)
        labels_dir = args.vispr_labels or "vispr_labels"
        vispr_train = VisprImageSource(args.vispr_train, os.path.join(labels_dir, "train_labels.pkl"))
        vispr_test = VisprImageSource(args.vispr_test, os.path.join(labels_dir, "test_labels.pkl"))
        recon_paths = sorted(glob.glob(os.path.join(args.vispr_train, "*.jpg")))
        if args.ucf101_frames:
            recon_paths += sorted(glob.glob(os.path.join(args.ucf101_frames, "*", "*.jpg")))
        recon_train = recon_val = ReconstructionSource(image_paths=recon_paths)
        # FeatureDataset takes the FIRST ``abnormal_split`` entries as abnormal
        # (datasets/dataset.py:26-48), and a sorted glob interleaves UCF-Crime's normal
        # directories (Testing_Normal_Videos_Anomaly, Training-Normal-Videos) among the
        # crime categories: partition abnormal-first and count the split.
        all_uris = sorted(glob.glob(args.crime_glob))

        def is_normal(u: str) -> bool:
            return "normal" in os.path.basename(os.path.dirname(u)).lower()

        crime_uris = [u for u in all_uris if not is_normal(u)] + [u for u in all_uris if is_normal(u)]
        abnormal_split = sum(1 for u in crime_uris if not is_normal(u))
        # The reference trains MGFN on the train split and reports AUC on the test
        # split; without a test glob the training videos are scored (a plumbing check,
        # not comparable to the reference's AUC).
        if args.crime_test_glob:
            test_uris = sorted(glob.glob(args.crime_test_glob))
        else:
            test_uris = crime_uris
            log("WARNING: no --crime_test_glob — MGFN AUC will be measured on the "
                "TRAINING videos (not comparable to the reference's test-split AUC)")
        with open(os.path.join(save, "parity_crime_order.txt"), "w") as f:
            f.write("\n".join(test_uris) + "\n")
        crime_gt = np.load(args.crime_gt)
        decode_hw = (240, 320)
        shape_kw = {}

    # ---- phase 1a: ft action training on UCF101 -----------------------------------
    # The reference seeds anonymization with a UCF101-finetuned ft (ft_i3d_ucf101.pth,
    # train_anonymizer.py:336) that action training builds from the Kinetics seed.
    log("== parity 0/6: ft action training (UCF101)")
    act = _maybe_overlay(ActionParams(run_id="parity_action"), args.params_dir, "action")
    act = act.replace(num_classes=num_classes, saved_model=seeds.get("ft"), temporal_loss="trip")
    if dry:
        act = act.replace(batch_size=4, v_batch_size=4, num_modes=2, val_freq=1, **shape_kw)
    action = train_action(act, train_items=train_items, val_items=val_items, save_dir=save,
                          max_epochs=ep, decode_hw=decode_hw, seed=args.seed, device=device)
    ft_seed_path = action["best_path"] or seeds.get("ft")
    lap("action")

    # ---- phase 1: fa reconstruction pretraining ----------------------------------
    log("== parity 1/6: fa reconstruction pretraining")
    rp = _maybe_overlay(ReconstructionParams(run_id="parity_recon"), args.params_dir, "recon")
    if dry:
        rp = rp.replace(batch_size=8, warmup=1,
                        **{k: v for k, v in shape_kw.items() if k != "num_frames"})
    rec = train_reconstruction(rp, train_source=recon_train, val_source=recon_val,
                               save_dir=save, max_epochs=ep, seed=args.seed, device=device)
    lap("recon")

    # ---- phase 2: adversarial anonymization --------------------------------------
    log("== parity 2/6: adversarial anonymization")
    ano = _maybe_overlay(AnonymizationParams(run_id="parity_anon"), args.params_dir, "anon")
    # The reference's fb seed is an SSL-pretrained fb (fb_ssl.pth, train_anonymizer.py:
    # 338) with the SimCLR projection head; the ImageNet r50 converted above is the
    # headless predictor and does not fit this slot. --fb_ssl_ckpt takes a converted
    # one; without it the fb starts from its seeded init.
    ano = ano.replace(saved_model_fa=rec["best_path"] or seeds.get("fa"),
                      saved_model_ft=ft_seed_path, saved_model_fb=args.fb_ssl_ckpt,
                      num_classes=num_classes)
    if dry:
        ano = ano.replace(batch_size=2, batch_size_vispr=4, v_batch_size=2, num_modes=2,
                          save_acc_threshold=-1.0, **shape_kw)
    anon = train_anonymizer(ano, train_items=train_items, val_items=val_items,
                            vispr_source=vispr_train, save_dir=save, max_epochs=ep,
                            seed=args.seed, device=device)
    lap("anon")

    # ---- phase 3: privacy attack, raw vs anonymized ------------------------------
    log("== parity 3/6: privacy attack (raw)")
    pp = _maybe_overlay(PrivacyParams(run_id="parity_priv_raw"), args.params_dir, "privacy")
    if dry:
        pp = pp.replace(batch_size=8, v_batch_size=8, warmup=1,
                        **{k: v for k, v in shape_kw.items() if k != "num_frames"})
    priv_raw = train_privacy(pp.replace(anon=False), train_source=vispr_train,
                             val_source=vispr_test, save_dir=save, max_epochs=ep,
                             seed=args.seed, device=device)
    lap("privacy_raw")
    log("== parity 3/6: privacy attack (anonymized)")
    priv_anon = train_privacy(
        pp.replace(anon=True, run_id="parity_priv_anon"), train_source=vispr_train,
        val_source=vispr_test, save_dir=save, fa_model=anon["fa"], max_epochs=ep,
        seed=args.seed, device=device,
    )
    lap("privacy_anon")

    # ---- phase 4: feature extraction, raw vs anonymized --------------------------
    log("== parity 4/6: feature extraction (raw + anonymized)")
    fx = _maybe_overlay(FeatureExtractionParams(run_id="parity_extract"), args.params_dir,
                        "extract")
    fx = fx.replace(num_classes=num_classes, **(shape_kw if dry else {}))
    # The trained models serve in the extraction's dtype (JAX applies their variables
    # in it); nothing trains them after this point.
    dtype = torch_dtype(fx.compute_dtype)
    fa, ft = anon["fa"].to(dtype=dtype), anon["ft"].to(dtype=dtype)
    feats = {}
    extract_uris = crime_uris + [u for u in test_uris if u not in set(crime_uris)]
    extract_batch = 4 if dry else max(fx.batch_size, 8)
    for branch in ("raw", "anon"):
        res = extract_features(
            fx.replace(anonymized=branch == "anon"), extract_uris,
            os.path.join(save, f"parity_features_{branch}"),
            fa=fa if branch == "anon" else None, ft=ft,
            batch_size=extract_batch, decode_hw=decode_hw,
            num_workers=args.num_workers, device=device,
        )
        if res["skipped"]:
            log(f"   {branch}: skipped {len(res['skipped'])} undecodable videos")
        feats[branch] = res
        lap(f"extract_{branch}")

    # ---- phase 5: MGFN, raw vs anonymized ----------------------------------------
    log("== parity 5/6: MGFN anomaly detection (raw + anonymized)")
    aucs = {}
    old_split = fm.ABNORMAL_SPLIT.get("UCF")
    fm.ABNORMAL_SPLIT["UCF"] = abnormal_split
    try:
        for branch in ("raw", "anon"):
            lst, tlst = mgfn_lists(branch, feats[branch], extract_uris, crime_uris, test_uris,
                                   crime_gt, save)
            mp = MGFNParams(rgb_list=lst, test_rgb_list=tlst, feature_size=2048,
                            model_name=f"parity_mgfn_{branch}")
            if dry:
                mp = mp.replace(dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16,
                                batch_size=2 if args.tiny else 3, dropout_rate=0.3)
            mg = train_anomaly_detection(mp, save_dir=save, gt=crime_gt, max_epochs=max(ep, 2),
                                         shuffle=True, device=device)
            aucs[branch] = max(mg["history"]["test_AUC"])
            lap(f"mgfn_{branch}")
    finally:
        if old_split is not None:
            fm.ABNORMAL_SPLIT["UCF"] = old_split

    # ---- phase 6: delta report ---------------------------------------------------
    log("== parity 6/6: delta report")
    cmap_raw, cmap_anon = priv_raw["best_cmap"], priv_anon["best_cmap"]
    cmap_delta_pct = (cmap_anon - cmap_raw) / max(cmap_raw, 1e-9) * 100.0
    auc_delta_pts = (aucs["anon"] - aucs["raw"]) * 100.0
    report = {
        "mode": "dry-run (synthetic; deltas NOT comparable to baseline)" if dry else "real-data",
        "cmap_raw": cmap_raw,
        "cmap_anon": cmap_anon,
        "cmap_delta_pct": cmap_delta_pct,
        "cmap_delta_target_pct": BASELINE_CMAP_DELTA_PCT,
        "auc_raw": aucs["raw"],
        "auc_anon": aucs["anon"],
        "auc_delta_pts": auc_delta_pts,
        "auc_delta_target_pts": BASELINE_AUC_DELTA_PTS,
        "extraction_clips_per_sec": feats["anon"]["clips_per_sec"],
        "seeds_converted": sorted(seeds),
    }
    out = os.path.join(save, "parity_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    log(f"  cMAP  raw {cmap_raw:.4f} -> anon {cmap_anon:.4f}  "
        f"delta {cmap_delta_pct:+.2f}% (target {BASELINE_CMAP_DELTA_PCT}%)")
    log(f"  AUC   raw {aucs['raw']:.4f} -> anon {aucs['anon']:.4f}  "
        f"delta {auc_delta_pts:+.2f} pts (target {BASELINE_AUC_DELTA_PTS} pts)")
    log(f"  stage seconds: {json.dumps({k: round(v, 3) for k, v in seconds.items()})}")
    log(f"  report: {out}")
    sizes = {"train_videos": len(train_items), "val_videos": len(val_items),
             "vispr_train": len(vispr_train), "vispr_test": len(vispr_test),
             "recon_val": len(recon_val), "recon_batch": rp.batch_size,
             "anon_batch": ano.batch_size, "anon_vispr_batch": ano.batch_size_vispr,
             "anon_val_batch": ano.v_batch_size, "anon_modes": ano.num_modes,
             "privacy_batch": pp.batch_size, "privacy_val_batch": pp.v_batch_size,
             "extract_batch": extract_batch,
             "extract_clips": {b: feats[b]["clips"] for b in ("raw", "anon")}}
    return {**report, "stage_seconds": seconds, "sizes": sizes}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dry-run", action="store_true",
                    help="synthetic data + seeds drawn in the published layout; validates the chain")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    ap.add_argument("--save_dir", default="parity_runs")
    ap.add_argument("--epochs", type=int, default=1, help="epochs per stage (dry-run: 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true", help="smallest dry-run (CI test scale)")
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--seeds_dir", default=None)
    ap.add_argument("--fb_ssl_ckpt", default=None,
                    help="pre-converted SSL fb checkpoint (the reference's fb_ssl.pth slot)")
    ap.add_argument("--params_dir", default=None,
                    help="reference checkout root; its params_*.py files overlay our configs")
    ap.add_argument("--ucf101_train_list")
    ap.add_argument("--ucf101_val_list")
    ap.add_argument("--ucf101_videos")
    ap.add_argument("--ucf101_frames")
    ap.add_argument("--vispr_train")
    ap.add_argument("--vispr_test")
    ap.add_argument("--vispr_labels", help="dir with {train,test}_labels.pkl (vispr_labels/)")
    ap.add_argument("--crime_glob", help="UCF-Crime TRAINING videos glob")
    ap.add_argument("--crime_test_glob",
                    help="held-out test videos glob (reference test split); without it "
                    "the MGFN AUC is measured on the training videos")
    ap.add_argument("--crime_gt",
                    help=".npy frame labels concatenated in parity_crime_order.txt "
                    "order (build with make_gt)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    if not args.dry_run:
        missing = [r for r in REAL_DATA_ARGS if not getattr(args, r)]
        if missing:
            raise SystemExit(f"real-data mode needs --{' --'.join(missing)} (or use --dry-run)")
    return run_parity(args)


if __name__ == "__main__":
    main()
