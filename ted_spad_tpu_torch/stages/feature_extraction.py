"""Feature extraction, the serving path's throughput stage (counterpart of
ted_spad_tpu/stages/feature_extraction.py; reference
feature_extraction/dali_extraction.py).

Windowing: 16-frame clips at stride 2, non-overlapping step 32. Per clip batch:
uint8 clips -> preprocess (kernel K1 on CUDA: crop, antialiased resize to 224^2,
/255) -> frozen fa per frame (UNet++, or the plain UNet whose DoubleConvs run kernel
K2 on CUDA; ``arch_fa``) -> ft ``extract_features`` (``arch_ft``: I3Res50 2048-d,
InceptionI3d 1024-d, R3D-18 512-d, MViTv2-S 768-d) -> one feature per clip, stacked
into a per-video ``.npy`` of (num_clips, F).

Options (``FeatureExtractionParams``), all through K1 on the card:
- ``ncrops`` 5 or 10: torchvision's five / ten crops of ``cropping_factor`` in one K1
  launch (the ten-crop's mirrored five mirrored in the kernel's stores); the crop axis
  rides through fa and is folded into ft's batch, so files are (num_clips, ncrops, F),
  the published MGFN layout;
- ``no_ar_distortion``: a square centre window of ``cropping_factor`` of the shorter
  side, so the resize keeps the aspect ratio;
- ``quirk_compat``: the reference extraction's return reshape between fa and ft
  (``ops/temporal.extraction_return_scramble``).
``ncrops`` > 1 excludes the other two, as in the JAX package; ``quant="int8"`` is not
ported (NotImplementedError).

Host/device overlap: host decode threads pack clips from several videos into
fixed-size batches; each batch is copied from pinned memory with ``non_blocking``
and enqueued, and the host drains the PREVIOUS batch's features while the card
computes the current one.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from ted_spad_tpu_torch.config.params import FeatureExtractionParams
from ted_spad_tpu_torch.data.video_reader import open_video
from ted_spad_tpu_torch.models import UNet, load_fa_model, load_ft_model
from ted_spad_tpu_torch.ops.preprocess import (
    Crop, center_crop, fused_preprocess, fused_preprocess_reference, multi_crops,
)
from ted_spad_tpu_torch.ops.temporal import extraction_return_scramble
from ted_spad_tpu_torch.utils.device import resolve_device, tf32_off, torch_dtype
from ted_spad_tpu_torch.utils.naming import dedup_names


@dataclasses.dataclass
class ClipRef:
    video_idx: int
    clip_idx: int


def video_clip_starts(num_frames_total: int, num_frames: int, stride: int, step: int) -> list[int]:
    """Non-overlapping window starts 0, step, 2*step... while a full strided clip
    fits; a video shorter than one clip still gives one (dali_extraction.py:66-76)."""
    span = (num_frames - 1) * stride + 1
    return list(range(0, max(num_frames_total - span + 1, 1), step))


def check_supported(p: FeatureExtractionParams) -> None:
    """Raise NotImplementedError for ``quant`` other than "none" (the int8 mode is not
    ported) and ValueError where the JAX stage refuses a combination: ``ncrops`` in
    {1, 5, 10}, and ``ncrops > 1`` with neither ``quirk_compat`` nor
    ``no_ar_distortion``."""
    if p.quant != "none":
        raise NotImplementedError(f"FeatureExtractionParams.quant={p.quant!r} is not ported to "
                                  f"ted_spad_tpu_torch; only quant='none' is")
    if p.ncrops not in (1, 5, 10):
        raise ValueError(f"ncrops must be 1, 5 or 10, got {p.ncrops}")
    if p.ncrops > 1 and (p.quirk_compat or p.no_ar_distortion):
        raise ValueError("ncrops > 1 (multi-crop TTA) supports only the plain rgb path — "
                         "not yuv ingest, quirk_compat, or no_ar_distortion")


def extraction_crops(p: FeatureExtractionParams, h: int, w: int) -> list[Crop] | None:
    """The crops the stage takes of an h x w frame: the five or ten of ``ncrops``, the
    square window of ``no_ar_distortion``, or None for the centre crop."""
    if p.ncrops > 1:
        return multi_crops(h, w, p.cropping_factor, p.ncrops)
    if p.no_ar_distortion:
        return [center_crop(h, w, p.cropping_factor, square=True)]
    return None


def iter_clip_batches(
    video_uris: Sequence[str],
    p: FeatureExtractionParams,
    batch_size: int,
    *,
    decode_hw: tuple[int, int] = (240, 320),
    num_workers: int = 8,
    on_error: Callable[[int, str], None] | None = None,
) -> Iterator[tuple[np.ndarray, list[ClipRef], dict[int, int]]]:
    """Stream (batch_size, T, H, W, 3) uint8 clip batches packed across videos.

    ``on_error``: when given, a video whose decode raises is skipped: the callback
    receives (video_idx, error_repr) and no clip of that video is yielded. When
    None, decode errors propagate.

    Yields (clips, refs, clip_counts): refs map batch rows to (video, clip),
    clip_counts gives each finished video's total clips. The last batch is padded
    by repeating its final clip (rows beyond refs are padding)."""
    from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

    clip_counts: dict[int, int] = {}
    # With fewer videos than workers (one long video served), the idle worker
    # budget becomes decoder frame threads; threading never changes pixels.
    decoder_threads = max(1, num_workers // max(len(video_uris), 1))

    def decode_video(vi: int):
        vr = open_video(video_uris[vi], decode_hw[1], decode_hw[0], threads=decoder_threads)
        try:
            starts = video_clip_starts(len(vr), p.num_frames, p.clip_stride, p.clip_step)
            clips = [(ClipRef(vi, ci), vr.read_strided(s, p.num_frames, p.clip_stride))
                     for ci, s in enumerate(starts)]
        finally:
            vr.close()
        return vi, clips

    # Completion-order draining with a bounded look-ahead window: a slow video
    # never blocks the device, and at most ``window`` decoded videos are buffered.
    pool = ThreadPoolExecutor(num_workers)
    window = max(2 * num_workers, 4)
    next_video = 0
    futures: set = set()
    vi_of: dict[Any, int] = {}

    def submit_next() -> None:
        nonlocal next_video
        if next_video < len(video_uris):
            f = pool.submit(decode_video, next_video)
            vi_of[f] = next_video
            futures.add(f)
            next_video += 1

    for _ in range(min(window, len(video_uris))):
        submit_next()

    buf_clips: list[np.ndarray] = []
    buf_refs: list[ClipRef] = []
    try:
        while futures:
            done, futures = wait(futures, return_when=FIRST_COMPLETED)
            for fut in done:
                fut_vi = vi_of.pop(fut, -1)
                try:
                    vi, clips = fut.result()
                except Exception as e:  # noqa: BLE001 -- per-video tolerance, see docstring
                    if on_error is None:
                        raise
                    on_error(fut_vi, repr(e))
                    submit_next()
                    continue
                clip_counts[vi] = len(clips)
                for ref, clip in clips:
                    buf_refs.append(ref)
                    buf_clips.append(clip)
                    if len(buf_clips) == batch_size:
                        yield np.stack(buf_clips), list(buf_refs), dict(clip_counts)
                        buf_clips, buf_refs = [], []
                submit_next()
        if buf_clips:
            refs = list(buf_refs)
            while len(buf_clips) < batch_size:
                buf_clips.append(buf_clips[-1])
            yield np.stack(buf_clips), refs, dict(clip_counts)
    finally:
        # Also on GeneratorExit when the consumer abandons the generator: queued
        # decodes must not keep running on pool threads after an error.
        pool.shutdown(wait=False, cancel_futures=True)


def _module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def make_extract_step(
    ft_model: torch.nn.Module,
    p: FeatureExtractionParams,
    fa: torch.nn.Module | None = None,
    *,
    use_kernel: bool | None = None,
    device: str | torch.device = "cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """One step: (B, T, H, W, 3) uint8 clips on ``device`` -> (B, F) float32, or
    (B, ncrops, F) with ``p.ncrops > 1`` (F: the ft's feature width).

    Preprocess -> (frozen fa per frame) -> (``quirk_compat``: the return scramble) ->
    ft ``extract_features`` over clips and crops, under ``torch.inference_mode()``, in
    the models' dtype (bf16 on the card by default).
    ``use_kernel`` (default: True on CUDA) selects every kernel of the step against
    its plain version, as the JAX package's ``use_pallas``: True runs the preprocess
    through kernel K1 and a UNet fa's DoubleConvs through kernel K2; False runs the
    plain preprocess in float32 and the plain DoubleConv.
    Float32 convolutions and matmuls run with TF32 off during the step
    (utils/device.tf32_off); the caller's TF32 settings are left as they were."""
    check_supported(p)
    device = resolve_device(device)
    for module in (ft_model, fa):
        if module is not None and _module_device(module) != device:
            raise ValueError(f"model on {_module_device(module)}, step on {device}")
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    out_dtype = torch_dtype(p.compute_dtype)
    fa_kw = {"use_kernel": use_kernel} if isinstance(fa, UNet) else {}

    def preprocess(clips_u8: torch.Tensor) -> torch.Tensor:
        """(B, T, h, w, 3), or (B, ncrops, T, h, w, 3) with ``p.ncrops > 1``."""
        crops = extraction_crops(p, *clips_u8.shape[2:4])
        kw = dict(out_h=p.reso_h, out_w=p.reso_w, cropping_factor=p.cropping_factor, crops=crops)
        if use_kernel:
            img = fused_preprocess(clips_u8, out_dtype=out_dtype, **kw)
        else:
            img = fused_preprocess_reference(clips_u8, out_dtype=torch.float32, **kw)
        return img[:, 0] if crops is not None and p.ncrops == 1 else img

    def extract(clips_u8: torch.Tensor) -> torch.Tensor:
        if clips_u8.device != device:
            raise ValueError(f"clips on {clips_u8.device}, step on {device}")
        with torch.inference_mode(), tf32_off():
            img = preprocess(clips_u8)
            lead, t = img.shape[:-4], img.shape[-4]
            n = lead.numel()  # clips x crops: folded into ft's batch
            # (n*T, 3, h, w) in channels_last memory: a view, no copy.
            frames = img.reshape((n * t,) + img.shape[-3:]).permute(0, 3, 1, 2)
            if fa is not None:
                frames = fa(frames, **fa_kw)  # (n*T, 3, h, w) float32
            frames = frames.permute(0, 2, 3, 1)
            if fa is not None and p.quirk_compat:
                clips = extraction_return_scramble(frames, n, t)
            else:
                clips = frames.reshape(n, t, *frames.shape[1:])
            # (n, 3, T, h, w): channels_last_3d when the frames are channels_last.
            feats = ft_model.extract_features(clips.permute(0, 4, 1, 2, 3))
            return feats.reshape(*lead, feats.shape[-1])

    return extract


def extract_features(
    p: FeatureExtractionParams,
    video_uris: Sequence[str],
    save_dir: str,
    *,
    fa: torch.nn.Module | None = None,
    ft: torch.nn.Module | None = None,
    batch_size: int | None = None,
    decode_hw: tuple[int, int] = (240, 320),
    shard_id: int = 0,
    num_shards: int = 1,
    num_workers: int = 8,
    device: str | torch.device = "cuda",
    log_fn: Callable[[str], None] = print,
) -> dict[str, Any]:
    """Run the extraction stage: one (num_clips, F) ``.npy`` per video, (num_clips,
    ncrops, F) with ``p.ncrops > 1``. Returns {"saved": {uri: path}, "existing": {uri: path},
    "skipped": {uri: error}, "clips", "elapsed_s", "clips_per_sec"}.

    ``fa`` / ``ft``: ready modules on ``device``; when None they are built by
    ``load_fa_model`` / ``load_ft_model`` from ``p`` (random weights from ``p.seed``).
    Videos are sharded round-robin (``shard_id`` of ``num_shards``); an existing
    ``.npy`` is skipped (resume) and reported under ``existing``; an undecodable
    video is skipped and reported under ``skipped``. Each ``.npy`` is written to a
    temporary name and moved into place atomically."""
    check_supported(p)
    device = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)

    # uri-hash dedup over the FULL list before sharding: same-basename videos in
    # different dirs must not clobber, including across shards.
    names = dedup_names(list(video_uris))

    def out_path(uri: str) -> str:
        return os.path.join(save_dir, names[uri] + ".npy")

    uris = [u for i, u in enumerate(video_uris) if i % num_shards == shard_id]
    existing = {u: out_path(u) for u in uris if os.path.exists(out_path(u))}
    uris = [u for u in uris if u not in existing]
    if not uris:
        return {"saved": {}, "existing": existing, "skipped": {}, "clips": 0,
                "elapsed_s": 0.0, "clips_per_sec": 0.0}

    if fa is None and p.anonymized:
        fa = load_fa_model(p.arch_fa, seed=p.seed, dtype=p.compute_dtype, device=device)
    if ft is None:
        ft = load_ft_model(p.arch_ft, seed=p.seed, dtype=p.compute_dtype, device=device,
                           clip_shape=(p.num_frames, p.reso_h, p.reso_w))
    extract = make_extract_step(ft, p, fa if p.anonymized else None, device=device)

    bs = batch_size or max(p.batch_size, 1)
    acc: dict[int, dict[int, np.ndarray]] = {}
    counts: dict[int, int] = {}
    saved: dict[str, str] = {}
    skipped: dict[str, str] = {}
    n_clips = 0
    cuda = device.type == "cuda"

    def flush_ready() -> None:
        """Write out every fully-accumulated video, atomically: resume-by-skip
        trusts bare existence, so a killed run must never leave a truncated .npy."""
        for vi in list(acc):
            if vi in counts and len(acc[vi]) == counts[vi]:
                feat = np.stack([acc[vi][c] for c in range(counts[vi])])
                path = out_path(uris[vi])
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    np.save(f, feat)
                os.replace(tmp, path)
                saved[uris[vi]] = path
                del acc[vi]

    def drain(entry) -> None:
        nonlocal n_clips
        feats, done, refs = entry
        if done is not None:
            done.synchronize()  # the device->host copy of this batch has landed
        feats = feats.numpy()
        for row, ref in enumerate(refs):
            acc.setdefault(ref.video_idx, {})[ref.clip_idx] = feats[row]
            n_clips += 1
        flush_ready()

    def record_skip(vi: int, err: str) -> None:
        uri = uris[vi] if 0 <= vi < len(uris) else f"<video #{vi}>"
        skipped[uri] = err
        log_fn(f"WARNING: skipping undecodable video {uri}: {err}")

    t0 = time.time()
    inflight: list = []
    for clips, refs, clip_counts in iter_clip_batches(
        uris, p, bs, decode_hw=decode_hw, num_workers=num_workers, on_error=record_skip,
    ):
        counts.update(clip_counts)
        host = torch.from_numpy(clips)
        done = None
        if cuda:
            # Pinned staging + async copies: the host returns at once and drains
            # the previous batch while the card computes this one.
            dev = host.pin_memory().to(device, non_blocking=True)
            feats = extract(dev)
            out = torch.empty(feats.shape, dtype=feats.dtype, pin_memory=True)
            out.copy_(feats, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            out = extract(host)
        inflight.append((out, done, refs))
        if len(inflight) > 1:
            drain(inflight.pop(0))
    while inflight:
        drain(inflight.pop(0))
    flush_ready()

    elapsed = time.time() - t0
    log_fn(f"extracted {n_clips} clips from {len(saved)} videos in {elapsed:.1f}s "
           f"({n_clips / max(elapsed, 1e-9):.2f} clips/s)"
           + (f"; skipped {len(skipped)} undecodable" if skipped else ""))
    return {"saved": saved, "existing": existing, "skipped": skipped, "clips": n_clips,
            "elapsed_s": elapsed, "clips_per_sec": n_clips / max(elapsed, 1e-9)}
