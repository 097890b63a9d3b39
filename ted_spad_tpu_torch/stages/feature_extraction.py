"""Feature extraction, the serving path's throughput stage (counterpart of
ted_spad_tpu/stages/feature_extraction.py; reference
feature_extraction/dali_extraction.py).

Windowing: 16-frame clips at stride 2, non-overlapping step 32. Per clip batch:
uint8 clips -> preprocess (kernel K1 on CUDA: crop, antialiased resize to 224^2,
/255) -> frozen fa per frame (UNet++ through its fused eval form, ops/fast_unetpp.py,
or the plain UNet whose DoubleConvs run kernel K2 on CUDA; ``arch_fa``) -> ft
``extract_features`` (``arch_ft``: I3Res50 2048-d with its s2d stem, ops/fast_i3d.py,
fed by the UNet++ head in the s2d layout; InceptionI3d 1024-d, R3D-18 512-d, MViTv2-S
768-d) -> one feature per clip, stacked into a per-video ``.npy`` of (num_clips, F).

Options (``FeatureExtractionParams``), all through K1 on the card:
- ``ncrops`` 5 or 10: torchvision's five / ten crops of ``cropping_factor`` in one K1
  launch (the ten-crop's mirrored five mirrored in the kernel's stores); the crop axis
  rides through fa and is folded into ft's batch, so files are (num_clips, ncrops, F),
  the published MGFN layout;
- ``no_ar_distortion``: a square centre window of ``cropping_factor`` of the shorter
  side, so the resize keeps the aspect ratio;
- ``quirk_compat``: the reference extraction's return reshape between fa and ft
  (``ops/temporal.extraction_return_scramble``).
``ncrops`` > 1 excludes the other two, as in the JAX package.

Modes:
- ``decode_mode="yuv"``: planar ingest. The host packs [Y | U | V | tag] rows at the
  videos' native resolution (1.5 bytes per pixel, no host colour conversion) and the
  card's preprocess (kernel K3, ops/yuv.py) resamples the planes, upsamples chroma and
  converts YCbCr to RGB with the colour set of each clip's tag byte. Not with
  ``no_ar_distortion`` or ``ncrops > 1``.
- ``quant="int8"``: the W8A8 serving mode (ops/quant_unetpp.py, ops/quant_i3d.py, kernel
  K4). ``extract_features`` calibrates activation scales on the run's first
  ``quant_calib_batches`` batches, extracts every batch with int8 convolutions, and
  with ``quant_fidelity_check`` reports the int8 features' cosine to the bf16 path's on
  the first batch. The fa must be the standard UNet++ (checked before anything is
  decoded); the ft is quantized too when it is the I3Res50 and ``quant_ft`` is set.

Host/device overlap: host decode threads pack clips from several videos into
fixed-size batches; each batch is copied from pinned memory with ``non_blocking``
and enqueued, and the host drains the PREVIOUS batch's features while the card
computes the current one.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from ted_spad_tpu_torch.config.params import FeatureExtractionParams
from ted_spad_tpu_torch.data.video_reader import open_video
from ted_spad_tpu_torch.models import UNet, load_fa_model, load_ft_model
from ted_spad_tpu_torch.models.i3res50 import WrapperI3D
from ted_spad_tpu_torch.ops.fast_i3d import make_fast_ft_extract
from ted_spad_tpu_torch.ops.fast_unetpp import make_fast_fa_apply
from ted_spad_tpu_torch.ops.preprocess import (
    Crop, center_crop, fused_preprocess, fused_preprocess_reference, multi_crops,
)
from ted_spad_tpu_torch.ops.quant_i3d import calibrate_i3d, make_quant_ft_extract
from ted_spad_tpu_torch.ops.quant_unetpp import (
    act_scales_from_absmax, calibrate_unetpp, check_quant_fa, make_quant_fa_apply,
)
from ted_spad_tpu_torch.ops.temporal import extraction_return_scramble
from ted_spad_tpu_torch.ops.yuv import (
    fused_preprocess_yuv, fused_preprocess_yuv_reference, unpack_yuv,
)
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


def check_supported(p: FeatureExtractionParams, yuv: bool = False) -> None:
    """Raise ValueError where the JAX stage refuses a combination: ``quant`` other than
    "none" or "int8", ``ncrops`` outside {1, 5, 10}, YUV ingest with
    ``no_ar_distortion``, and ``ncrops > 1`` with YUV ingest, ``quirk_compat`` or
    ``no_ar_distortion``."""
    if p.quant not in ("none", "int8"):
        raise ValueError(f"quant must be 'none' or 'int8', got {p.quant!r}")
    if yuv and p.no_ar_distortion:
        raise ValueError("yuv mode does not support no_ar_distortion; use rgb")
    if p.ncrops not in (1, 5, 10):
        raise ValueError(f"ncrops must be 1, 5 or 10, got {p.ncrops}")
    if p.ncrops > 1 and (yuv or p.quirk_compat or p.no_ar_distortion):
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
    decode_mode: str = "rgb",
    on_error: Callable[[int, str], None] | None = None,
) -> Iterator[tuple[np.ndarray, list[ClipRef], dict[int, int]]]:
    """Stream (batch_size, T, H, W, 3) uint8 clip batches packed across videos.

    ``decode_mode="yuv"``: batches are (batch_size, T, H*W*3/2 + 1) uint8 [Y | U | V |
    tag] rows at the videos' native resolution, which must be ``decode_hw``. The tag
    byte is a bitmask: bit 0 = BT.709 matrix, bit 1 = full-range transfer. A video
    whose colorspace is neither BT.601 (or untagged) nor BT.709 is refused.

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

    if decode_mode not in ("rgb", "yuv"):
        raise ValueError(f"decode_mode must be 'rgb' or 'yuv', got {decode_mode!r}")

    def read_yuv(vr, uri: str, start: int, cs_tag: int) -> np.ndarray:
        y, u, v, full = vr.read_strided_yuv(start, p.num_frames, p.clip_stride)
        if y.shape[-2:] != tuple(decode_hw):
            raise RuntimeError(f"{uri}: native size {y.shape[-2:]} != decode_hw {decode_hw} — "
                               "yuv mode reads at native resolution; pass matching decode_hw "
                               "or use decode_mode='rgb' (which rescales)")
        t = y.shape[0]
        tag = np.full((t, 1), cs_tag | (2 if full else 0), np.uint8)
        return np.concatenate([y.reshape(t, -1), u.reshape(t, -1), v.reshape(t, -1), tag], axis=1)

    def decode_video(vi: int):
        uri = video_uris[vi]
        vr = open_video(uri, decode_hw[1], decode_hw[0], threads=decoder_threads)
        try:
            starts = video_clip_starts(len(vr), p.num_frames, p.clip_stride, p.clip_step)
            if decode_mode == "yuv":
                cs = getattr(vr, "colorspace", 0)  # one property per video
                if cs not in (0, 601, 709):  # untagged is swscale's BT.601 default
                    raise RuntimeError(
                        f"{uri}: colorspace tag {cs} — the YUV ingest path supports BT.601 "
                        "(and untagged, swscale's default) and BT.709; use decode_mode='rgb' "
                        "for this source")
                cs_tag = 1 if cs == 709 else 0  # tag-byte bit 0
                clips = [(ClipRef(vi, ci), read_yuv(vr, uri, s, cs_tag))
                         for ci, s in enumerate(starts)]
            else:
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


def _make_preprocess(p: FeatureExtractionParams, use_kernel: bool, yuv: bool,
                     yuv_hw: tuple[int, int]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The step's preprocess, shared with the int8 calibration step so the calibrated fa
    sees the serving inputs: uint8 clips -> (B, T, h, w, 3) frames (or (B, ncrops, T, h,
    w, 3)) in the compute dtype through K1 / K3 (``use_kernel``), or in float32 through
    their plain versions."""
    out_dtype = torch_dtype(p.compute_dtype) if use_kernel else torch.float32
    kw = dict(out_h=p.reso_h, out_w=p.reso_w, cropping_factor=p.cropping_factor)

    def preprocess(clips_u8: torch.Tensor) -> torch.Tensor:
        if yuv:
            if use_kernel:
                return fused_preprocess_yuv(clips_u8, yuv_hw, out_dtype=out_dtype, **kw)
            y, u, v, bt709, full = unpack_yuv(clips_u8, yuv_hw)
            return fused_preprocess_yuv_reference(y, u, v, out_dtype=out_dtype, bt709=bt709,
                                                  full=full, **kw)
        crops = extraction_crops(p, *clips_u8.shape[2:4])
        fn = fused_preprocess if use_kernel else fused_preprocess_reference
        img = fn(clips_u8, out_dtype=out_dtype, crops=crops, **kw)
        return img[:, 0] if crops is not None and p.ncrops == 1 else img

    return preprocess


def make_fa_calibration_step(
    p: FeatureExtractionParams,
    fa: torch.nn.Module,
    ft: torch.nn.Module | None = None,
    *,
    use_kernel: bool | None = None,
    device: str | torch.device = "cuda",
    yuv: bool = False,
    yuv_hw: tuple[int, int] = (240, 320),
) -> Callable[[torch.Tensor], dict[str, torch.Tensor]]:
    """One calibration step of the int8 mode: the extraction preprocess and the
    quantization schedule in the compute dtype (``calibrate_unetpp``), ``clips_u8 ->
    {site: absmax}``; callers max-reduce across batches and feed
    ``act_scales_from_absmax``. With ``ft`` (the I3Res50) the chain continues through its
    feature path as the int8 step runs it (``calibrate_i3d``), on exactly the tensor that
    step feeds it: under ``quirk_compat`` the scrambled fa output (the JAX package
    calibrates ft on the unscrambled clips there). Launches no int8 convolution."""
    check_supported(p, yuv)
    check_quant_fa(fa)
    device = resolve_device(device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    preprocess = _make_preprocess(p, use_kernel, yuv, yuv_hw)

    def calib(clips_u8: torch.Tensor) -> dict[str, torch.Tensor]:
        with torch.inference_mode(), tf32_off():
            img = preprocess(clips_u8)
            lead, t = img.shape[:-4], img.shape[-4]
            n = lead.numel()
            anon, stats = calibrate_unetpp(fa, img.reshape((n * t,) + img.shape[-3:]))
            if ft is None:
                return stats
            if p.quirk_compat:
                clips = extraction_return_scramble(anon, n, t)
            else:
                clips = anon.reshape((n, t) + anon.shape[1:])
            _, ft_stats = calibrate_i3d(ft, clips)
            if set(stats) & set(ft_stats):
                raise AssertionError("fa/ft calibration site collision")
            return {**stats, **ft_stats}

    return calib


def make_extract_step(
    ft_model: torch.nn.Module,
    p: FeatureExtractionParams,
    fa: torch.nn.Module | None = None,
    *,
    use_kernel: bool | None = None,
    device: str | torch.device = "cuda",
    yuv: bool = False,
    yuv_hw: tuple[int, int] = (240, 320),
    quant_act_scales: dict[str, float] | None = None,
    int8_kernel: bool | None = None,
    fast_forms: bool = True,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """One step: (B, T, H, W, 3) uint8 clips on ``device`` -> (B, F) float32, or
    (B, ncrops, F) with ``p.ncrops > 1`` (F: the ft's feature width).

    Preprocess -> (frozen fa per frame) -> (``quirk_compat``: the return scramble) ->
    ft ``extract_features`` over clips and crops, under ``torch.inference_mode()``, in
    the models' dtype (bf16 on the card by default).
    ``use_kernel`` (default: True on CUDA) selects every kernel of the step against
    its plain version, as the JAX package's ``use_pallas``: True runs the preprocess
    through kernel K1 (K3 with ``yuv``) and a UNet fa's DoubleConvs through kernel K2;
    False runs the plain preprocess in float32 and the plain DoubleConv.
    ``yuv``: the step takes (B, T, H*W*3/2 [+1]) packed [Y | U | V (| tag)] rows of
    ``yuv_hw`` frames (``decode_mode="yuv"``).
    ``quant_act_scales``: calibrated per-site activation scales (``make_fa_calibration_step``
    + ``act_scales_from_absmax``, or the JAX package's): the fa runs the int8 W8A8 path,
    and the ft too when the scales hold its sites (``i3d_in``). ``int8_kernel`` (default:
    ``use_kernel``) runs its int8 convolutions through kernel K4, or with False through
    the plain int8 conv.
    ``fast_forms`` (default True, as in the JAX package): the fa through its fused eval
    form (``make_fast_fa_apply``: a UNet++ with folded BN and no upsampled or
    concatenated tensors; a UNet still runs its module, K2 and all) and an I3Res50 ft
    through its s2d stem (``make_fast_ft_extract``). Where neither quirk_compat is set
    nor a side 16 does not divide, and both support it, the fa's head writes the s2d
    layout the ft's stem reads (``emit_s2d`` -> ``input_s2d``). False runs the module
    forwards (the fidelity gate's reference).
    Float32 convolutions and matmuls run with TF32 off during the step
    (utils/device.tf32_off); the caller's TF32 settings are left as they were."""
    check_supported(p, yuv)
    device = resolve_device(device)
    for module in (ft_model, fa):
        if module is not None and _module_device(module) != device:
            raise ValueError(f"model on {_module_device(module)}, step on {device}")
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    if int8_kernel is None:
        int8_kernel = use_kernel
    preprocess = _make_preprocess(p, use_kernel, yuv, yuv_hw)
    fa_apply = None
    fa_kw = {"use_kernel": use_kernel} if isinstance(fa, UNet) else {}
    if fa is not None:
        if quant_act_scales is not None:
            fa_apply = make_quant_fa_apply(fa, quant_act_scales, use_kernel=int8_kernel)
        elif fast_forms:
            fa_apply = make_fast_fa_apply(fa)
        else:
            fa_apply = fa
    if quant_act_scales is not None and "i3d_in" in quant_act_scales:
        ft_extract = make_quant_ft_extract(ft_model, quant_act_scales, use_kernel=int8_kernel)
    elif fast_forms:
        ft_extract = make_fast_ft_extract(ft_model)
    else:
        ft_extract = ft_model.extract_features
    # The s2d bridge, under the JAX package's condition.
    bridged = (fa is not None and not p.quirk_compat
               and getattr(fa_apply, "supports_s2d", False)
               and getattr(ft_extract, "supports_s2d", False)
               and p.reso_h % 16 == 0 and p.reso_w % 16 == 0)

    def extract(clips_u8: torch.Tensor) -> torch.Tensor:
        if clips_u8.device != device:
            raise ValueError(f"clips on {clips_u8.device}, step on {device}")
        with torch.inference_mode(), tf32_off():
            img = preprocess(clips_u8)
            lead, t = img.shape[:-4], img.shape[-4]
            n = lead.numel()  # clips x crops: folded into ft's batch
            # (n*T, 3, h, w) in channels_last memory: a view, no copy.
            frames = img.reshape((n * t,) + img.shape[-3:]).permute(0, 3, 1, 2)
            if bridged:
                # (n*T, 12, h/2, w/2) s2d frames -> (n, 12, T, h/2, w/2): views.
                s2d = fa_apply(frames, emit_s2d=True).permute(0, 2, 3, 1)
                clips = s2d.reshape(n, t, *s2d.shape[1:]).permute(0, 4, 1, 2, 3)
                feats = ft_extract(clips, input_s2d=True)
                return feats.reshape(*lead, feats.shape[-1])
            if fa_apply is not None:
                frames = fa_apply(frames, **fa_kw)  # (n*T, 3, h, w) float32
            frames = frames.permute(0, 2, 3, 1)
            if fa is not None and p.quirk_compat:
                clips = extraction_return_scramble(frames, n, t)
            else:
                clips = frames.reshape(n, t, *frames.shape[1:])
            # (n, 3, T, h, w): channels_last_3d when the frames are channels_last.
            feats = ft_extract(clips.permute(0, 4, 1, 2, 3))
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
    decode_mode: str = "rgb",
    num_workers: int = 8,
    device: str | torch.device = "cuda",
    log_fn: Callable[[str], None] = print,
    mesh=None,
) -> dict[str, Any]:
    """Run the extraction stage: one (num_clips, F) ``.npy`` per video, (num_clips,
    ncrops, F) with ``p.ncrops > 1``. Returns {"saved": {uri: path}, "existing": {uri: path},
    "skipped": {uri: error}, "clips", "elapsed_s", "clips_per_sec"}, and with
    ``p.quant="int8"`` "quant_calib_batches_used" and (``p.quant_fidelity_check``)
    "quant_feature_cossim_vs_bf16".

    ``fa`` / ``ft``: ready modules on ``device``; when None they are built by
    ``load_fa_model`` / ``load_ft_model`` from ``p`` (random weights from ``p.seed``).
    ``decode_mode="yuv"``: planar ingest (the preprocess is kernel K3; ``decode_hw``
    must be the videos' native size). ``p.quant="int8"``: the int8 serving mode,
    calibrated on the run's first ``p.quant_calib_batches`` batches, which are then
    extracted like the others; the fa (and ft) configuration is checked before anything
    is decoded. Videos are sharded round-robin (``shard_id`` of ``num_shards``); an
    existing ``.npy`` is skipped (resume) and reported under ``existing``; an
    undecodable video is skipped and reported under ``skipped``. Each ``.npy`` is
    written to a temporary name and moved into place atomically.

    ``mesh`` (parallel.DataParallelMesh): one process per card, each extracting its
    ``process_shard()`` of the videos (``shard_id`` = rank of ``num_shards`` = world
    size) on ``mesh.device``; a batch never spans processes. Every rank returns the
    whole run's ``saved`` / ``existing`` / ``skipped`` maps and clip count (its own
    under ``"shard"``), after every rank's files are on disk."""
    if mesh is not None:
        device, shard_id, num_shards = mesh.device, mesh.rank, mesh.world_size
        shard = extract_features(p, video_uris, save_dir, fa=fa, ft=ft, batch_size=batch_size,
                                 decode_hw=decode_hw, shard_id=shard_id, num_shards=num_shards,
                                 decode_mode=decode_mode, num_workers=num_workers,
                                 device=device, log_fn=log_fn)
        every = mesh.exchange({k: shard[k] for k in ("saved", "existing", "skipped", "clips",
                                                     "elapsed_s")})
        merged = {k: {u: path for r in every for u, path in r[k].items()}
                  for k in ("saved", "existing", "skipped")}
        clips = sum(r["clips"] for r in every)
        elapsed = max(r["elapsed_s"] for r in every)
        return {**merged, "clips": clips, "elapsed_s": elapsed,
                "clips_per_sec": clips / max(elapsed, 1e-9), "shard": shard}
    yuv = decode_mode == "yuv"
    if decode_mode not in ("rgb", "yuv"):
        raise ValueError(f"decode_mode must be 'rgb' or 'yuv', got {decode_mode!r}")
    check_supported(p, yuv)
    if p.quant == "int8" and not p.anonymized:
        raise ValueError("quant='int8' quantizes the fa anonymizer — requires anonymized=True")
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
    if not p.anonymized:
        fa = None
    ft_quant = None
    if p.quant == "int8":
        # The configuration is checked before any decode or calibration: a non-standard
        # fa raises here, not deep inside the calibration pass.
        check_quant_fa(fa)
        if p.quant_ft:
            if isinstance(ft, WrapperI3D):
                ft_quant = ft
            else:
                log_fn("quant int8: ft is not a standard WrapperI3D — quantizing fa only")

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

    def to_device(clips: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(clips)
        # Pinned staging + an async copy: the host returns at once.
        return host.pin_memory().to(device, non_blocking=True) if cuda else host

    t0 = time.time()
    batch_iter = iter_clip_batches(uris, p, bs, decode_hw=decode_hw, num_workers=num_workers,
                                   decode_mode=decode_mode, on_error=record_skip)
    quant_scales = None
    quant_stats: dict[str, Any] = {}
    if p.quant == "int8":
        # Calibrate on the run's own leading batches (same decode, same preprocess), then
        # chain them back so they are extracted like the others.
        calib = make_fa_calibration_step(p, fa, ft_quant, device=device, yuv=yuv,
                                         yuv_hw=decode_hw)
        head_batches = []
        absmax: dict[str, float] = {}
        for b in itertools.islice(batch_iter, max(1, p.quant_calib_batches)):
            head_batches.append(b)
            stats = calib(to_device(b[0]))
            for k, v in zip(stats, torch.stack(list(stats.values())).tolist()):
                absmax[k] = max(absmax.get(k, 0.0), v)
        if not head_batches:
            log_fn("WARNING: no decodable batches to calibrate on; nothing to extract")
            return {"saved": {}, "existing": existing, "skipped": skipped, "clips": 0,
                    "elapsed_s": 0.0, "clips_per_sec": 0.0}
        quant_scales = act_scales_from_absmax(absmax)
        quant_stats["quant_calib_batches_used"] = len(head_batches)
        batch_iter = itertools.chain(head_batches, batch_iter)

    extract = make_extract_step(ft, p, fa, device=device, yuv=yuv, yuv_hw=decode_hw,
                                quant_act_scales=quant_scales)
    if quant_scales is not None and p.quant_fidelity_check:
        # The int8 features against the bf16 path's on the first calibration batch,
        # logged and returned, so every quantized run carries its own evidence.
        ref_step = make_extract_step(ft, p, fa, device=device, yuv=yuv, yuv_hw=decode_hw)
        b0 = to_device(head_batches[0][0])
        fq = extract(b0).double()
        fq = fq.reshape(-1, fq.shape[-1])  # (clips [x crops], F)
        fr = ref_step(b0).double().reshape(fq.shape)
        cos = torch.nn.functional.cosine_similarity(fq, fr, dim=-1, eps=1e-12).mean()
        quant_stats["quant_feature_cossim_vs_bf16"] = round(float(cos), 5)
        log_fn(f"quant int8: feature cosine similarity vs bf16 on calibration batch: "
               f"{float(cos):.5f}")
        del ref_step

    inflight: list = []
    for clips, refs, clip_counts in batch_iter:
        counts.update(clip_counts)
        feats = extract(to_device(clips))
        done = None
        if cuda:
            # The host drains the previous batch while the card computes this one.
            out = torch.empty(feats.shape, dtype=feats.dtype, pin_memory=True)
            out.copy_(feats, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            out = feats
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
            "elapsed_s": elapsed, "clips_per_sec": n_clips / max(elapsed, 1e-9), **quant_stats}
