"""Adversarial-dynamics validation (counterpart of scripts/validate_adversarial.py):
does anonymization reduce privacy leakage, the paper's central claim (README.md:11, the
cMAP reduction after anonymization)?

    python -m ted_spad_tpu_torch.validate_adversarial [--scale tiny|reference] [--epochs N]

Trains the three-model adversarial stage, then two privacy attackers, one on raw
images and one on images the trained fa anonymizes, and prints both cMAPs and the
reduction (expected: cMAP anonymized < raw).

``--scale tiny`` (default): 8-frame 32^2 float32 clips of 48x64 synthetic videos,
64-canonical stripe images. ``--scale reference`` runs the same check at the
reference's production shapes (params_anonymization.py:52-59: 8 videos x 3 views + 12
VISPR pairs, 16 frames 224^2, bf16; remat "auto"): 48 / 12 synthetic videos of 96
frames at 240x320 and 256-canonical ``style="attrs"`` images (every privacy attribute
drawn, so the raw attacker has signal to lose). The reference never starts the
adversarial loop from a random fa but from the reconstruction pretraining
(fa_recon.pth, train_anonymizer.py:334), so this scale first runs a short L1
pretraining and seeds the fa from its ``model_temp.ckpt``, with a base LR of 2e-5
(2x the reference's: this run takes tens of fa steps where the reference takes
thousands).
"""

from __future__ import annotations

import argparse


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", choices=["tiny", "reference"], default="tiny",
                    help="'reference' = 16-frame 224^2 bf16 production shapes")
    ap.add_argument("--lr", type=float, default=None,
                    help="adversarial base LR (reference scale default 2e-5, tiny 1e-4)")
    ap.add_argument("--attack_epochs", type=int, default=None,
                    help="privacy-attacker training epochs (default 8 reference / 3 tiny)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="adversarial epochs (default 20 reference / 4 tiny)")
    ap.add_argument("--save_dir", type=str, default=None,
                    help="checkpoint directory (default: a new temporary directory)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    return ap


def run(args) -> dict:
    """The validation; returns {"anon", "raw", "anonymized", "delta", "seconds"}: the
    stages' summaries, the cMAP reduction and each stage's wall time (recon, anon,
    privacy_raw, privacy_anon)."""
    import os
    import tempfile
    import time

    from ted_spad_tpu_torch.config.params import (
        AnonymizationParams, PrivacyParams, ReconstructionParams,
    )
    from ted_spad_tpu_torch.data.images import SyntheticImageSource
    from ted_spad_tpu_torch.data.videos import synthetic_video_items
    from ted_spad_tpu_torch.stages.anonymization_training import train_anonymizer
    from ted_spad_tpu_torch.stages.fa_pretraining import train_reconstruction
    from ted_spad_tpu_torch.stages.privacy_training import train_privacy
    from ted_spad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    save = args.save_dir or tempfile.mkdtemp()
    seed = args.seed
    seconds: dict[str, float] = {}
    t0 = time.perf_counter()
    if args.scale == "reference":
        ep = args.epochs or 20
        attack_ep = args.attack_epochs or 8
        ano = AnonymizationParams(
            run_id="validate_anon", num_classes=4, batch_size=8, batch_size_vispr=12,
            v_batch_size=4, num_modes=2, save_acc_threshold=-1.0,
            learning_rate=args.lr or 2e-5,
        )
        train_items = synthetic_video_items(48, 4, num_frames=96, h=240, w=320, seed=seed)
        val_items = synthetic_video_items(12, 4, num_frames=96, h=240, w=320, seed=seed + 1)
        vispr = SyntheticImageSource(n=160, canonical=256, seed=seed, style="attrs")
        pp = PrivacyParams(batch_size=8, v_batch_size=8, warmup=1, learning_rate=1e-3,
                           compute_dtype="bfloat16")
        tr = SyntheticImageSource(n=256, canonical=256, seed=seed, style="attrs")
        va = SyntheticImageSource(n=128, canonical=256, seed=seed + 1, style="attrs")
        # A random-init fa's unbounded output passes train-mode BN but explodes through
        # the ft's eval-mode BN at 224^2 (finite train losses, NaN validation logits):
        # seed the fa from a short L1 reconstruction pretraining, as the reference does.
        rp = ReconstructionParams(run_id="validate_recon", batch_size=8,
                                  compute_dtype="bfloat16")
        train_reconstruction(rp, train_source=vispr, val_source=None, save_dir=save,
                             max_epochs=2, log_fn=lambda s: None, seed=seed, device=device)
        seconds["recon"] = time.perf_counter() - t0
        ano = ano.replace(saved_model_fa=os.path.join(save, rp.run_id, "model_temp.ckpt"))
    else:
        ep = args.epochs or 4
        attack_ep = args.attack_epochs or 3
        ano = AnonymizationParams(
            run_id="validate_anon", num_classes=4, num_frames=8, reso_h=32, reso_w=32,
            batch_size=2, batch_size_vispr=8, v_batch_size=2, num_modes=2,
            compute_dtype="float32", save_acc_threshold=-1.0, learning_rate=args.lr or 1e-4,
        )
        train_items = synthetic_video_items(12, 4, num_frames=48, h=48, w=64, seed=seed)
        val_items = synthetic_video_items(6, 4, num_frames=48, h=48, w=64, seed=seed + 1)
        vispr = SyntheticImageSource(n=32, canonical=64, seed=seed)
        pp = PrivacyParams(reso_h=32, reso_w=32, batch_size=8, v_batch_size=8,
                           compute_dtype="float32", warmup=1, learning_rate=1e-3)
        tr = SyntheticImageSource(n=48, canonical=64, seed=seed)
        va = SyntheticImageSource(n=32, canonical=64, seed=seed + 1)

    t0 = time.perf_counter()
    anon = train_anonymizer(ano, train_items=train_items, val_items=val_items,
                            vispr_source=vispr, save_dir=save, max_epochs=ep, device=device)
    t1 = time.perf_counter()
    raw = train_privacy(pp.replace(anon=False, run_id="validate_priv_raw"), train_source=tr,
                        val_source=va, save_dir=save, max_epochs=attack_ep, device=device)
    t2 = time.perf_counter()
    anonp = train_privacy(pp.replace(anon=True, run_id="validate_priv_anon"), train_source=tr,
                          val_source=va, save_dir=save, fa_model=anon["fa"],
                          max_epochs=attack_ep, device=device)
    seconds.update(anon=t1 - t0, privacy_raw=t2 - t1, privacy_anon=time.perf_counter() - t2)

    delta = raw["best_cmap"] - anonp["best_cmap"]
    print(f"\nprivacy cMAP raw:        {raw['best_cmap']:.4f}")
    print(f"privacy cMAP anonymized: {anonp['best_cmap']:.4f}")
    print(f"reduction:               {delta:+.4f} "
          f"({'privacy protected' if delta > 0 else 'no gain at this scale'})")
    print("stage seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return {"anon": anon, "raw": raw, "anonymized": anonp, "delta": delta, "seconds": seconds}


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
