"""The anonymizer's demo on a CUDA card, stage 4.5 (counterpart of
scripts/visualize_anonymization.py; reference visualization/visualize_anonymization.py):
each video through the fa, written as ``<name>_anon.mp4`` (``.y4m`` where the native
library is not available) and ``<name>_grid.png`` (originals over anonymized frames).

    python -m ted_spad_tpu_torch.visualize_anonymization --videos_glob 'cam/*.mp4' \\
        --saved_model_fa fa.ckpt --out_dir visualizations

``--saved_model_fa`` takes an fa checkpoint of either package (``fa_model_state_dict``);
without it the fa draws random weights (smoke runs only). Videos are decoded at
240x320. Same-basename videos in different directories get distinct stems.

Synthetic smoke on the CPU (one procedural 30-frame 48x64 video):
``python -m ted_spad_tpu_torch.visualize_anonymization --synthetic --device cpu --out_dir /tmp/viz``.
"""

from __future__ import annotations

import argparse
import glob


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--synthetic", action="store_true",
                    help="one procedural video at a small shape (no media needed)")
    ap.add_argument("--videos_glob", type=str, default=None)
    ap.add_argument("--saved_model_fa", type=str, default=None)
    ap.add_argument("--out_dir", type=str, default="visualizations")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    return ap


def run(args) -> dict[str, dict[str, str]]:
    """Visualize every video; returns ``{uri: {"video": path, "grid": path}}``."""
    from ted_spad_tpu_torch.models import load_fa_model
    from ted_spad_tpu_torch.stages.visualization import anonymize_video
    from ted_spad_tpu_torch.utils.device import resolve_device
    from ted_spad_tpu_torch.utils.naming import dedup_names

    device = resolve_device(args.device)
    if args.synthetic:
        uris, size = ["synthetic://n=30,h=48,w=64,seed=7"], (48, 64)
    else:
        if not args.videos_glob:
            raise SystemExit("pass --videos_glob or --synthetic")
        uris, size = sorted(glob.glob(args.videos_glob)), (240, 320)
        if not uris:
            raise SystemExit(f"--videos_glob {args.videos_glob!r} matched no files")
    fa = load_fa_model(saved_model_file=args.saved_model_fa, dtype="float32", device=device)
    names = dedup_names(uris)
    out = {}
    for uri in uris:
        out[uri] = anonymize_video(uri, args.out_dir, fa=fa, size=size, out_name=names[uri])
        print(f"{uri} -> {out[uri]['video']}, {out[uri]['grid']}")
    return out


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
