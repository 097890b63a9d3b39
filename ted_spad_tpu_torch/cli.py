"""Flags and inputs shared by the CLIs, one definition so they cannot drift: those of
the extraction-driven CLIs (``extract_features`` and ``score_video``) and ``--mesh``
(counterpart of scripts/_common.py's ``add_extraction_args``,
``resolve_extraction_inputs`` and ``maybe_mesh``)."""

from __future__ import annotations

import argparse
import glob

# The i3d ft pools a (2, 7, 7) window of its trunk map: its smallest clip (models/i3d.py).
I3D_SMALLEST_CLIP = (9, 193, 193)
SYNTHETIC_CLIP = (8, 32, 32)


def synthetic_clip(arch_ft: str) -> tuple[int, int, int]:
    """(T, H, W) of the ``--synthetic`` runs' clips for an ft family: 8x32x32, or the
    i3d ft's smallest clip (below it the port raises where JAX returns NaN)."""
    return I3D_SMALLEST_CLIP if arch_ft == "i3d" else SYNTHETIC_CLIP


def add_mesh_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--mesh", action="store_true",
                    help="data parallel, one process per card: under torchrun each process "
                         "joins the launcher's group; without one, a group of one on the card")
    ap.add_argument("--backend", type=str, default="nccl", choices=["nccl", "gloo"],
                    help="process-group backend of --mesh (gloo: the CPU, with --device cpu)")


def maybe_mesh(args):
    """The data-parallel mesh when ``--mesh`` is set, else None. Under a launcher
    (a cluster marker set: torchrun's RANK / WORLD_SIZE, ...) the process joins its
    group and a failure raises; without one it is a group of one on ``--device``
    (the card, ``cuda:LOCAL_RANK``, by default)."""
    if not getattr(args, "mesh", False):
        return None
    from ted_spad_tpu_torch.parallel import data_parallel_mesh, multihost

    if multihost.in_cluster():
        multihost.initialize_distributed(backend=args.backend)
    else:
        multihost.initialize_single(backend=args.backend)
    device = None if args.device == "cuda" else args.device
    return data_parallel_mesh(device)


def add_extraction_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--videos_glob", type=str, default=None)
    ap.add_argument("--params", type=str, default=None,
                    help="reference-style params_*.py overlaid on FeatureExtractionParams")
    ap.add_argument("--synthetic", action="store_true",
                    help="procedural videos at tiny shapes (no media needed)")
    ap.add_argument("--raw", action="store_true", help="skip anonymization (raw features)")
    ap.add_argument("--batch", type=int, default=8, help="clips per device step")
    ap.add_argument("--decode_mode", type=str, default="rgb", choices=["rgb", "yuv"],
                    help="'yuv': planar ingest, half the host->device bytes, chroma upsample "
                         "and YCbCr->RGB in the card's preprocess (kernel K3); reads at the "
                         "videos' native resolution, so set --decode_hw to it")
    ap.add_argument("--decode_hw", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="decode resolution (default 240 320); in yuv mode the videos' "
                         "native resolution")
    ap.add_argument("--num_workers", type=int, default=8, help="host decode threads")
    ap.add_argument("--ncrops", type=int, default=None, choices=[1, 5, 10],
                    help="crops per clip: 5 = corners + centre, 10 = + their mirrors (the "
                         "published MGFN feature layout); features become (num_clips, "
                         "ncrops, F)")
    ap.add_argument("--quant", type=str, default=None, choices=["none", "int8"],
                    help="'int8': the W8A8 serving mode (int8 convolutions through kernel "
                         "K4), calibrated on the run's first batches; logs the features' "
                         "cosine to the bf16 path's")
    ap.add_argument("--quant_calib_batches", type=int, default=None,
                    help="batches the int8 mode calibrates on (default 2)")
    ap.add_argument("--saved_model_fa", type=str, default=None,
                    help="fa checkpoint (fa_model_state_dict), as the JAX stages write it")
    ap.add_argument("--saved_model_ft", type=str, default=None,
                    help="ft checkpoint (ft_model_state_dict), as the JAX stages write it")
    ap.add_argument("--seed", type=int, default=0, help="seed of random weights")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    add_mesh_args(ap)


def extraction_inputs(args, *, n_synthetic: int):
    """``(FeatureExtractionParams, video uris, decode (H, W))`` from the shared flags.
    ``--synthetic``: ``n_synthetic`` procedural 40x80 videos of 120 frames, 8-frame
    clips at 32x32 in float32; an i3d ft takes its smallest clip instead, from videos
    of two clips (40 frames). A ``--videos_glob`` that matches nothing raises."""
    from ted_spad_tpu_torch.config.params import FeatureExtractionParams, apply_params_file

    p = apply_params_file(FeatureExtractionParams(anonymized=not args.raw, seed=args.seed),
                          args.params)
    if args.ncrops:
        p = p.replace(ncrops=args.ncrops)
    if args.quant:
        p = p.replace(quant=args.quant)
    if args.quant_calib_batches:
        p = p.replace(quant_calib_batches=args.quant_calib_batches)
    if args.synthetic:
        t, h, w = synthetic_clip(p.arch_ft)
        n = 40 if p.arch_ft == "i3d" else 120
        p = p.replace(num_frames=t, reso_h=h, reso_w=w, compute_dtype="float32")
        return p, [f"synthetic://n={n},h=40,w=80,seed={i}" for i in range(n_synthetic)], (40, 80)
    if not args.videos_glob:
        raise SystemExit("pass --videos_glob or --synthetic")
    uris = sorted(glob.glob(args.videos_glob))
    if not uris:
        raise SystemExit(f"--videos_glob {args.videos_glob!r} matched no files")
    return p, uris, tuple(args.decode_hw) if args.decode_hw else (240, 320)
