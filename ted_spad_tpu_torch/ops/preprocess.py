"""Fused uint8 clip preprocess: crop -> antialiased bilinear resize -> /255 (-> mirror).

Counterpart of ted_spad_tpu/ops/pallas_preprocess.py, and of the crops of
ted_spad_tpu/ops/augment.py that the JAX extraction stage sends through XLA
(5/10-crop, the square window of ``no_ar_distortion``). The separable resample is
``R_y @ img @ R_x^T`` per image plane, where ``resize_matrix`` bakes the crop
window, the triangle filter and the 1/255 gain into the matrices; a crop is a
``Crop`` (window and mirror flag), the centre crop being the default one.

- ``fused_preprocess_reference``: the plain version, two f32 ``torch.matmul``s per
  plane with the dense matrices, then a flip for a mirrored crop.
- ``fused_preprocess``: the kernel wrapper (K1, csrc/preprocess.cu). On a CUDA
  tensor it launches the hand-written kernel once for all crops of a batch; on a CPU
  tensor it runs the plain version. Its ``launches`` attribute counts kernel launches.
- ``k1_plan``: the kernel's instantiation, padded band tables and launch geometry for
  a shape and window, computed as the kernel reads them; raises ``ValueError`` where
  nothing fits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch


def resize_matrix(
    src: int,
    dst: int,
    crop_start: int = 0,
    crop_size: int | None = None,
    antialias: bool = True,
    scale_gain: float = 1.0,
) -> np.ndarray:
    """(dst, src) row-stochastic resample matrix: crop [crop_start, crop_start+crop_size)
    then resize to ``dst`` with the align_corners=False convention (antialiased
    triangle filter when downscaling). ``scale_gain`` folds constants (e.g. 1/255)
    into the matrix."""
    crop_size = crop_size if crop_size is not None else src
    scale = crop_size / dst
    support = max(scale, 1.0) if antialias else 1.0
    out = np.zeros((dst, src), np.float32)
    for o in range(dst):
        center = crop_start + (o + 0.5) * scale - 0.5
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        idx = np.arange(lo, hi + 1)
        w = 1.0 - np.abs(idx - center) / support
        w = np.clip(w, 0.0, None)
        # Edge handling: renormalize over taps INSIDE the crop window; resizing the
        # cropped array never sees pixels beyond the crop (matches crop-then-resize).
        valid = (idx >= crop_start) & (idx < crop_start + crop_size) & (idx >= 0) & (idx < src)
        w = w * valid
        s = w.sum()
        if s <= 0:
            nearest = int(np.clip(round(center), 0, src - 1))
            out[o, nearest] = 1.0
            continue
        out[o, idx[valid]] = w[valid] / s
    return out * scale_gain


def crop_window(size: int, cropping_factor: float, length: int | None = None) -> tuple[int, int]:
    """(start, length) of the center crop along one axis: ``length`` if given, else
    ``cropping_factor`` of ``size``, where ``cropping_factor > 1`` means no crop. The
    start rounds half to even, as torchvision's center_crop."""
    if length is None:
        length = int(size * cropping_factor) if cropping_factor <= 1 else size
    return int(round((size - length) / 2.0)), length


class Crop(NamedTuple):
    """A window of a frame (top row, left column, rows, columns) resized to the output,
    and whether the output is mirrored left to right."""
    y0: int
    x0: int
    h: int
    w: int
    mirror: bool = False

    @property
    def window(self) -> tuple[int, int, int, int]:
        return self.y0, self.x0, self.h, self.w


def center_crop(h: int, w: int, cropping_factor: float, square: bool = False) -> Crop:
    """The centre window of an h x w frame: ``cropping_factor`` of each side, or with
    ``square`` (``no_ar_distortion``) a square of that factor of the shorter side;
    the whole frame when ``cropping_factor > 1``."""
    side = int(min(h, w) * cropping_factor) if square and cropping_factor <= 1 else None
    y0, ch = crop_window(h, cropping_factor, side)
    x0, cw = crop_window(w, cropping_factor, side)
    return Crop(y0, x0, ch, cw)


def multi_crops(h: int, w: int, cropping_factor: float, ncrops: int) -> list[Crop]:
    """torchvision's five_crop / ten_crop windows of ``cropping_factor`` of each side:
    top-left, top-right, bottom-left, bottom-right, centre; for ten, then the five of
    the mirrored frame, which are the mirrored (tr, tl, br, bl, centre) views."""
    if ncrops not in (5, 10):
        raise ValueError(f"ncrops must be 5 or 10, got {ncrops}")
    if cropping_factor > 1:
        raise ValueError(f"multi-crop takes cropping_factor <= 1, got {cropping_factor}")
    c = center_crop(h, w, cropping_factor)
    five = [Crop(0, 0, c.h, c.w), Crop(0, w - c.w, c.h, c.w), Crop(h - c.h, 0, c.h, c.w),
            Crop(h - c.h, w - c.w, c.h, c.w), c]
    if ncrops == 5:
        return five
    return five + [five[i]._replace(mirror=True) for i in (1, 0, 3, 2, 4)]


@functools.lru_cache(maxsize=32)
def window_matrices(h: int, w: int, out_h: int, out_w: int, window: tuple[int, int, int, int]):
    """(R_y with the 1/255 gain, R_x) of one window (y0, x0, rows, columns) of an
    h x w frame resized to out_h x out_w, as numpy f32."""
    y0, x0, ch, cw = window
    ry = resize_matrix(h, out_h, y0, ch, scale_gain=1.0 / 255.0)
    rx = resize_matrix(w, out_w, x0, cw)
    return ry, rx


def preprocess_matrices(h: int, w: int, out_h: int, out_w: int, cropping_factor: float):
    """``window_matrices`` of the centre crop."""
    return window_matrices(h, w, out_h, out_w, center_crop(h, w, cropping_factor).window)


def band(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Banded form of a resample matrix: per output index the first input index
    and K weights (K = the widest row's span of nonzeros), such that
    ``m[o, start[o] + k] == weights[o, k]`` and every other entry of row o is 0.
    Starts are clamped so that ``start + K`` never passes the last input index any
    row uses: the bands together span exactly the inputs the matrix reads."""
    n_out = m.shape[0]
    nz = [np.flatnonzero(row) for row in m]
    k = max(int(z[-1] - z[0] + 1) for z in nz)
    end = max(int(z[-1]) for z in nz) + 1
    start = np.array([min(int(z[0]), end - k) for z in nz], np.int32)
    weights = np.stack([m[o, start[o] : start[o] + k] for o in range(n_out)]).astype(np.float32)
    return start, weights


def fused_preprocess_reference(
    clips_u8: torch.Tensor,
    *,
    out_h: int = 224,
    out_w: int = 224,
    cropping_factor: float = 0.8,
    crops: Sequence[Crop] | None = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version: (B, T, H, W, 3) uint8 -> (B, T, out_h, out_w, 3) ``out_dtype``
    (the centre crop of ``cropping_factor``), or with ``crops`` (B, len(crops), T,
    out_h, out_w, 3), as two f32 matmuls per plane with each window's dense resample
    matrices, then a flip of the mirrored crops."""
    b, t, h, w, c = clips_u8.shape
    planes = clips_u8.reshape(b * t, h, w, c).permute(0, 3, 1, 2).float()  # (BT, 3, H, W)
    views = []
    for crop in crops or [center_crop(h, w, float(cropping_factor))]:
        ry, rx = window_matrices(h, w, out_h, out_w, crop.window)
        ry = torch.from_numpy(ry).to(clips_u8.device)
        rxt = torch.from_numpy(rx).to(clips_u8.device).T
        out = torch.matmul(torch.matmul(ry, planes), rxt)  # (BT, 3, out_h, out_w)
        if crop.mirror:
            out = out.flip(-1)
        views.append(out.permute(0, 2, 3, 1).reshape(b, t, out_h, out_w, c).to(out_dtype))
    return torch.stack(views, dim=1) if crops else views[0]


K1_RUN = 8  # output pixels per thread (csrc/preprocess.cu: kRun)
# Compile-time taps of csrc/preprocess.cu (its K1_CASE table): (vertical taps, input
# columns per run, blocks per SM its registers allow), smallest first: the serving
# frame (240x320), ShanghaiTech's (480x856, also 360x640) and HD video (720p, 1080p)
# into 224x224. The first that holds the shape's taps is taken; beyond them the
# runtime-taps instantiation runs (its registers allow K1_BLOCKS_PER_SM).
K1_TAPS = ((2, 12, 3), (4, 32, 3), (8, 64, 1))
K1_BANDS = (32, 16, 8, 4, 2, 1)  # output rows per block, largest first
# Three blocks per SM let their copies hide one another's latency. They fit where each
# block's shared memory and its 1 KB reservation take a third of the SM's, and where
# the instantiation needs at most 80 registers a thread (3 x 256 threads x 80 = 61,440
# of the SM's 65,536; chip_probes.k1_register_report holds each build to its entry).
K1_BLOCKS_PER_SM = 3
REGISTERS_PER_SM = 65_536
SMEM_PER_SM = 233_472  # an H100 SM's shared memory
SMEM_RESERVED_PER_BLOCK = 1_024
SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory an H100 block may opt into


class K1Plan(NamedTuple):
    """How K1 runs one input/output shape, as csrc/preprocess.cu lays it out."""
    kernel: str  # the instantiation, "K1<KY, SPAN>" or "K1<runtime>"
    ky: int  # vertical taps as launched (padded up to the instantiation's)
    span: int  # input columns per run of K1_RUN outputs, as launched
    static: bool  # compile-time taps with the tables in shared memory
    band_rows: int  # output rows per block; a block is one (frame, band)
    n_bands: int
    rows_buf: int  # staged input rows: the most any band needs
    row_pitch: int  # bytes per staged row
    smem_bytes: int  # dynamic shared memory of one block
    blocks_per_sm: int  # as many as the registers allow where the block fits them, else 1
    col0: int  # first window column; the kernel reads columns [col0, col0 + n_cols)
    n_cols: int
    runs: int  # runs of K1_RUN outputs per output row
    vstart: np.ndarray  # (out_h,) int32: first input row of each output row's band
    vw: np.ndarray  # (out_h, ky) float32: the band's weights (R_y, 1/255 folded in)
    xs: np.ndarray  # (runs,) int32: first input column of each run, from col0
    wrun: np.ndarray  # (runs, span, K1_RUN) float32: R_x over each run's columns
    key: tuple  # (h, w, out_h, out_w, window): keys the device copy of the tables


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _row_bands(ry: np.ndarray, ky: int) -> tuple[np.ndarray, np.ndarray]:
    """``band(ry)`` padded to ``ky`` taps: starts moved down so that the taps end no
    later than the last input row R_y uses (and never before row 0), zero weights past
    the frame."""
    start, _ = band(ry)
    end = int(np.flatnonzero(ry.any(axis=0))[-1]) + 1
    start = np.maximum(0, np.minimum(start, end - ky)).astype(np.int32)
    idx = start[:, None] + np.arange(ky)
    inside = idx < ry.shape[1]
    w = np.where(inside, ry[np.arange(ry.shape[0])[:, None], np.minimum(idx, ry.shape[1] - 1)], 0)
    return start, w.astype(np.float32)


def _run_tiles(rx: np.ndarray, span: int) -> tuple[np.ndarray, np.ndarray]:
    """(first column of each run relative to the window, (runs, span, K1_RUN) dense
    tile of R_x over the run's columns, zero past the frame or the last output)."""
    out_w, w = rx.shape
    start, _ = band(rx)
    col0 = int(start.min())
    xs = (start[::K1_RUN] - col0).astype(np.int32)
    wrun = np.zeros((len(xs), span, K1_RUN), np.float32)
    for r, x in enumerate(xs):
        cols = col0 + int(x) + np.arange(span)
        ok = cols < w
        for q in range(min(K1_RUN, out_w - r * K1_RUN)):
            wrun[r, ok, q] = rx[r * K1_RUN + q, cols[ok]]
    return xs, wrun


def _table_sizes(runs: int, span: int, out_h: int, ky: int) -> list[int]:
    """Words of each table segment (wrun, vw, xs, vstart), each rounded up to 4."""
    return [_cdiv(n, 4) * 4 for n in (runs * (span * K1_RUN + 4), out_h * ky, runs, out_h)]


def _table_words(plan: K1Plan) -> tuple[np.ndarray, tuple[int, ...]]:
    """The tables as one float32 word array, laid out as csrc/preprocess.cu reads
    them: each run's weight tile padded by 4 words (which spreads the 16-byte reads of
    neighbouring runs over the banks), then vw, xs and vstart (int32 bits), each
    segment a multiple of 4 words. Returns (words, word offsets of the four)."""
    tiles = plan.wrun.reshape(plan.runs, -1)
    segs = [np.concatenate([tiles, np.zeros((plan.runs, 4), np.float32)], axis=1).ravel(),
            plan.vw.ravel(), plan.xs.view(np.float32), plan.vstart.view(np.float32)]
    sizes = _table_sizes(plan.runs, plan.span, len(plan.vstart), plan.ky)
    words = np.concatenate([np.pad(seg, (0, n - len(seg))) for seg, n in zip(segs, sizes)])
    return words, tuple(int(x) for x in np.cumsum([0] + sizes[:-1]))


def k1_plan(h: int, w: int, out_h: int, out_w: int, cropping_factor: float = 0.8, *,
            window: tuple[int, int, int, int] | None = None) -> K1Plan:
    """K1's instantiation, tables and launch geometry for one shape and window
    (y0, x0, rows, columns; default the centre crop of ``cropping_factor``). The taps
    are the first K1_TAPS entry that holds R_y's band and every run's columns, else the
    runtime-taps instantiation. The band is the largest of K1_BANDS whose block fits
    as many to an SM as the instantiation's registers allow, else the largest that fits
    one. Raises ValueError where nothing fits."""
    if window is None:
        window = center_crop(h, w, float(cropping_factor)).window
    return _window_plan(h, w, out_h, out_w, tuple(window))


@functools.lru_cache(maxsize=32)
def _window_plan(h: int, w: int, out_h: int, out_w: int, window: tuple) -> K1Plan:
    ry, rx = window_matrices(h, w, out_h, out_w, window)
    xstart, xw = band(rx)
    ky_used, kx = band(ry)[1].shape[1], xw.shape[1]
    col0 = int(xstart.min())
    n_cols = int(xstart.max()) + kx - col0
    span_used = max(int(xstart[min(o + K1_RUN, out_w) - 1]) + kx - int(xstart[o])
                    for o in range(0, out_w, K1_RUN))
    variants = [(k, s, b, True) for k, s, b in K1_TAPS if k >= ky_used and s >= span_used]
    variants = variants[:1] + [(ky_used, _cdiv(span_used, 4) * 4, K1_BLOCKS_PER_SM, False)]
    for ky, span, most_blocks, static in variants:
        limits = [(1, SMEM_PER_BLOCK)]  # (blocks per SM, shared memory a block may take)
        if most_blocks > 1:
            limits.insert(0, (most_blocks, SMEM_PER_SM // most_blocks - SMEM_RESERVED_PER_BLOCK))
        vstart, vw = _row_bands(ry, ky)
        xs, wrun = _run_tiles(rx, span)
        runs = len(xs)
        row_pitch = _cdiv(max(15 + 3 * n_cols, 19 + 3 * (int(xs.max()) + span)), 16) * 16
        table_bytes = 4 * sum(_table_sizes(runs, span, out_h, ky))
        for blocks, limit in limits:
            for rows in K1_BANDS:
                rows_buf = max(int(vstart[min(o + rows, out_h) - 1]) + ky - int(vstart[o])
                               for o in range(0, out_h, rows))
                smem = (table_bytes if static else 0) + rows_buf * row_pitch
                if smem <= limit:
                    name = f"K1<{ky}, {span}>" if static else "K1<runtime>"
                    return K1Plan(name, ky, span, static, rows, _cdiv(out_h, rows), rows_buf,
                                  row_pitch, smem, blocks, col0, n_cols, runs, vstart, vw, xs,
                                  wrun, (h, w, out_h, out_w, window))
    raise ValueError(f"fused_preprocess: a {h}x{w} frame does not fit the kernel's shared "
                     f"memory (one staged input row is {row_pitch} B)")


@functools.lru_cache(maxsize=16)
def _device_tables(key: tuple, device: torch.device) -> tuple[torch.Tensor, tuple[int, ...]]:
    """The tables of the plan keyed ``key`` on ``device`` and their word offsets."""
    words, offsets = _table_words(_window_plan(*key))
    return torch.from_numpy(words).to(device), offsets


@functools.cache
def _library():
    from ted_spad_tpu_torch.utils.cuda_build import load

    lib = load("preprocess")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ted_preprocess_u8.restype = i
    lib.ted_preprocess_u8.argtypes = [p, ctypes.c_longlong, p, i, p] + [i] * 20 + [p, p, i, i]
    return lib


K1_MAX_CROPS = 16  # csrc/preprocess.cu: kMaxCrops


def _crop_table(plan: K1Plan, h: int, w: int, crops: Sequence[Crop]) -> np.ndarray:
    """(dy, dx, mirror) of each crop against the planned window, the first crop's: the
    kernel shifts that window's tables, so every crop must have its size and, shifted,
    read inside the frame."""
    first = crops[0]
    rows = []
    for crop in crops:
        if (crop.h, crop.w) != (first.h, first.w):
            raise ValueError(f"fused_preprocess: crops of one launch share a size, got {crops}")
        if not (0 <= crop.y0 and crop.y0 + crop.h <= h and 0 <= crop.x0 and crop.x0 + crop.w <= w):
            raise ValueError(f"fused_preprocess: {crop} lies outside a {h}x{w} frame")
        dy, dx = crop.y0 - first.y0, crop.x0 - first.x0
        if int(plan.vstart.min()) + dy < 0 or not 0 <= plan.col0 + dx <= w - plan.n_cols:
            raise ValueError(f"fused_preprocess: {crop} shifts the planned window out of the frame")
        rows.append((dy, dx, int(crop.mirror)))
    return np.ascontiguousarray(rows, dtype=np.int32)


def fused_preprocess(
    clips_u8: torch.Tensor,
    *,
    out_h: int = 224,
    out_w: int = 224,
    cropping_factor: float = 0.8,
    crops: Sequence[Crop] | None = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 -> (B, T, out_h, out_w, 3) normalized [0, 1] ``out_dtype``
    (the centre crop of ``cropping_factor``), or with ``crops`` (windows of one size,
    each optionally mirrored) -> (B, len(crops), T, out_h, out_w, 3).

    On CUDA this launches kernel K1 once on the current stream, for every crop. Its
    output memory is (frames, out_h, out_w, 3), i.e. frames in NCHW ``channels_last``
    format after a permute, which costs no copy. On the CPU it runs
    ``fused_preprocess_reference``.
    """
    if clips_u8.dtype != torch.uint8 or clips_u8.dim() != 5 or clips_u8.shape[-1] != 3:
        raise ValueError(f"fused_preprocess takes (B, T, H, W, 3) uint8, got "
                         f"{tuple(clips_u8.shape)} {clips_u8.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_preprocess writes float32 or bfloat16, not {out_dtype}")
    if crops is not None and not 0 < len(crops) <= K1_MAX_CROPS:
        raise ValueError(f"fused_preprocess takes 1 to {K1_MAX_CROPS} crops, got {len(crops)}")
    if clips_u8.device.type == "cpu":
        return fused_preprocess_reference(clips_u8, out_h=out_h, out_w=out_w,
                                          cropping_factor=cropping_factor, crops=crops,
                                          out_dtype=out_dtype)
    if clips_u8.device.type != "cuda":
        raise ValueError(f"fused_preprocess runs on cuda or cpu, not {clips_u8.device}")
    if not clips_u8.is_contiguous():
        raise ValueError("fused_preprocess needs a contiguous clip batch")
    b, t, h, w, c = clips_u8.shape
    launch_crops = list(crops) if crops is not None else [center_crop(h, w, float(cropping_factor))]
    plan = k1_plan(h, w, out_h, out_w, window=launch_crops[0].window)
    table = _crop_table(plan, h, w, launch_crops)
    n = len(launch_crops)
    if b * t * plan.n_bands >= 2**31:
        raise ValueError(f"fused_preprocess launches one block per frame and band: {b * t} "
                         f"frames x {plan.n_bands} bands exceed the grid's 2**31 - 1")
    shape = (b, t) if crops is None else (b, n, t)
    out = torch.empty(shape + (out_h, out_w, c), dtype=out_dtype, device=clips_u8.device)
    tables, (wrun_off, vw_off, xs_off, vstart_off) = _device_tables(plan.key, clips_u8.device)
    with torch.cuda.device(clips_u8.device):
        err = _library().ted_preprocess_u8(
            clips_u8.data_ptr(), clips_u8.numel(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), tables.data_ptr(), tables.numel(), wrun_off,
            vw_off, xs_off, vstart_off, plan.ky, plan.span, int(plan.static), b * t, h, w,
            plan.col0, plan.n_cols, out_h, out_w, plan.runs, plan.band_rows, plan.rows_buf,
            plan.row_pitch, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream, table.ctypes.data, n, t,
        )
    if err != 0:
        raise RuntimeError(f"fused_preprocess: kernel launch failed with cudaError {err}")
    fused_preprocess.launches += 1
    return out


fused_preprocess.launches = 0
