"""Frame-level ground truth of a test list (counterpart of scripts/make_gt.py;
reference anomaly_detection_mgfn/data/make_gt_{ucf,sh,xd}.py):

    python -m ted_spad_tpu_torch.make_gt --dataset UCF --test_list ucf-i3d-test.list \\
        --annotations_dir UCF_Crimes/Temporal_Anomaly_Annotation --out gt-ucf.npy

The test list names one feature ``.npy`` per video; each video's clip count sets
its frame count (32 frames per clip for UCF and XD, 16 for ST).

- UCF: ``--annotations_dir`` holds ``<Class>_x264.mat`` temporal annotations; a
  video whose path holds ``Normal_`` is normal.
- ST: ``--annotations_dir`` holds the frame masks ``<video>.npy``; the first 44
  videos of the list are abnormal.
- XD: ``--annotations_txt`` holds "name s1 e1 s2 e2 ..." lines; the first 300
  videos of the list are normal. A video takes the line of its exact name, else the
  one line whose name contains it; no match or several raise.

Writes one concatenated float ``.npy`` and prints its length and positive rate.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ted_spad_tpu_torch.data.features import read_list
from ted_spad_tpu_torch.data.gt_builders import (
    parse_xd_annotation_line, shanghai_video_gt, ucf_video_gt, xd_video_gt,
)

ST_ABNORMAL = 44  # make_gt_sh.py:37
XD_NORMAL = 300  # make_gt_xd.py:29


def _num_clips(path: str) -> int:
    return np.load(path, allow_pickle=True).shape[0]


def ucf_gt(paths: list[str], annotations_dir: str) -> list[np.ndarray]:
    from scipy.io import loadmat

    parts = []
    for path in paths:
        nf = _num_clips(path) * 32
        if "Normal_" in path:
            parts.append(ucf_video_gt(nf, None))
            continue
        stem = os.path.basename(path).split("_")[0]
        annots = loadmat(os.path.join(annotations_dir, stem + "_x264.mat"))
        rows = annots["Annotation_file"]["Anno"].tolist()[0][0]
        parts.append(ucf_video_gt(nf, [tuple(int(v) for v in row[:2]) for row in rows]))
    return parts


def st_gt(paths: list[str], annotations_dir: str) -> list[np.ndarray]:
    parts = []
    for i, path in enumerate(paths):
        nf = _num_clips(path) * 16
        mask = (np.load(os.path.join(annotations_dir, os.path.basename(path)))
                if i < ST_ABNORMAL else None)
        parts.append(shanghai_video_gt(nf, mask))
    return parts


def xd_spans(stem: str, annos: dict[str, list]) -> list:
    """The spans of the line named ``stem``, else of the one line whose name holds it."""
    if stem in annos:
        return annos[stem]
    matches = [k for k in annos if stem in k]
    if not matches:
        raise SystemExit(f"no XD annotation line matches {stem!r}")
    if len(matches) > 1:
        raise SystemExit(f"ambiguous XD annotation match for {stem!r}: {matches[:4]}")
    return annos[matches[0]]


def xd_gt(paths: list[str], annotations_txt: str) -> list[np.ndarray]:
    with open(annotations_txt) as f:
        annos = dict(parse_xd_annotation_line(ln) for ln in f.read().splitlines() if ln)
    parts = []
    for i, path in enumerate(paths):
        nf = _num_clips(path) * 32
        spans = None if i < XD_NORMAL else xd_spans(os.path.basename(path)[:-4], annos)
        parts.append(xd_video_gt(nf, spans))
    return parts


def run(args) -> np.ndarray:
    paths = read_list(args.test_list)
    if args.dataset == "XD":
        parts = xd_gt(paths, args.annotations_txt)
    else:
        parts = (ucf_gt if args.dataset == "UCF" else st_gt)(paths, args.annotations_dir)
    gt = np.concatenate(parts)
    np.save(args.out, gt)
    print(f"wrote {args.out}: {len(gt)} frames, {gt.mean():.4f} positive rate")
    return gt


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", type=str, required=True, choices=["UCF", "ST", "XD"])
    ap.add_argument("--test_list", type=str, required=True)
    ap.add_argument("--annotations_dir", type=str, default=None)
    ap.add_argument("--annotations_txt", type=str, default=None)
    ap.add_argument("--out", type=str, required=True)
    return ap


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
