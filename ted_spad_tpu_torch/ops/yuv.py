"""YUV420 planar ingest on the card: crop + antialiased resize + chroma upsample +
YCbCr -> RGB + /255 (counterpart of ted_spad_tpu/ops/yuv.py).

The planar decode mode ships [Y | U | V (| tag)] rows, 1.5 bytes per pixel, instead of
RGB24's 3, and does the colour conversion on the card. Colour conversion is affine in
(Y, U, V) and the resample matrices are row-stochastic over the crop window, so the
planes are resampled first (chroma straight from half resolution to the output grid,
which absorbs the 2x upsample) and the affine colour matrix is applied after.

- ``fused_preprocess_yuv_reference``: the plain version, JAX's ``fused_preprocess_yuv``
  in torch: per-plane float32 matmuls, the per-row BT.601 / BT.709 and limited / full
  range coefficient selects, ``/ 255`` then the clip to [0, 1].
- ``fused_preprocess_yuv``: the kernel wrapper (K3, csrc/preprocess_yuv.cu). It takes
  the packed (B, T, H*W*3/2 [+1]) rows directly; on a CUDA tensor it launches the
  hand-written kernel, on a CPU tensor it splits the planes and runs the plain version.
  Its ``launches`` attribute counts kernel launches.
- ``k3_plan``: the kernel's instantiation, banded tables and launch geometry for a
  frame size, computed as the kernel reads them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ted_spad_tpu_torch.ops.preprocess import (
    K1_RUN, SMEM_PER_BLOCK, _cdiv, _row_bands, _run_tiles, band, crop_window, resize_matrix,
)

# YCbCr -> RGB affine coefficients (ted_spad_tpu/ops/yuv.py:31-35). Limited (studio)
# range is swscale's untagged default; full range is the yuvj / pc case.
BT601_LIMITED = dict(ky=1.164383, y_off=16.0, rv=1.596027, gu=-0.391762, gv=-0.812968, bu=2.017232)
BT601_FULL = dict(ky=1.0, y_off=0.0, rv=1.402, gu=-0.344136, gv=-0.714136, bu=1.772)
BT709_LIMITED = dict(ky=1.164383, y_off=16.0, rv=1.792741, gu=-0.213249, gv=-0.532909, bu=2.112402)
BT709_FULL = dict(ky=1.0, y_off=0.0, rv=1.5748, gu=-0.187324, gv=-0.468124, bu=1.8556)
# Indexed by bt709 + 2 * full, as the tag byte selects them (csrc/preprocess_yuv.cu: kColor).
COLOR_SETS = (BT601_LIMITED, BT709_LIMITED, BT601_FULL, BT709_FULL)


def yuv_window(h: int, w: int, cropping_factor: float) -> tuple[int, int, int, int]:
    """(y0, x0, rows, columns) of the centre crop of an h x w frame; raises ValueError
    unless the window, and the frame, are chroma-aligned (even offsets and sizes)."""
    y0, ch = crop_window(h, cropping_factor)
    x0, cw = crop_window(w, cropping_factor)
    if y0 % 2 or x0 % 2 or ch % 2 or cw % 2 or h % 2 or w % 2:
        raise ValueError(f"chroma-misaligned crop ({y0},{x0},{ch},{cw}) of a {h}x{w} frame — "
                         "use the RGB path")
    return y0, x0, ch, cw


@functools.lru_cache(maxsize=16)
def yuv_matrices(h: int, w: int, out_h: int, out_w: int, cropping_factor: float):
    """(R_y, R_x, cR_y, cR_x) as numpy float32: the luma window's resample matrices and
    the chroma planes' (half resolution, half window) ones."""
    y0, x0, ch, cw = yuv_window(h, w, cropping_factor)
    return (resize_matrix(h, out_h, y0, ch), resize_matrix(w, out_w, x0, cw),
            resize_matrix(h // 2, out_h, y0 // 2, ch // 2),
            resize_matrix(w // 2, out_w, x0 // 2, cw // 2))


def fused_preprocess_yuv_reference(
    y_u8: torch.Tensor,
    u_u8: torch.Tensor,
    v_u8: torch.Tensor,
    *,
    out_h: int = 224,
    out_w: int = 224,
    cropping_factor: float = 0.8,
    out_dtype: torch.dtype = torch.bfloat16,
    full_range: bool = False,
    bt709: torch.Tensor | None = None,
    full: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version: (B, T, H, W) + 2 x (B, T, H/2, W/2) uint8 planes -> (B, T, out_h,
    out_w, 3) RGB in [0, 1], ``out_dtype``.

    ``bt709`` / ``full``: optional (B,) bool row flags selecting BT.709 over BT.601 and
    the full-range transfer over limited range per clip; None: BT.601 and the static
    ``full_range``. Raises ValueError for a chroma-misaligned crop window."""
    h, w = y_u8.shape[-2], y_u8.shape[-1]
    ry, rx, cry, crx = (torch.from_numpy(m).to(y_u8.device)
                        for m in yuv_matrices(h, w, out_h, out_w, float(cropping_factor)))

    def resample(plane, a, b):
        return torch.matmul(torch.matmul(a, plane.float()), b.T)

    yf = resample(y_u8, ry, rx)
    uf = resample(u_u8, cry, crx) - 128.0
    vf = resample(v_u8, cry, crx) - 128.0
    if bt709 is None and full is None:
        c = {k: torch.tensor(v, dtype=torch.float32)
             for k, v in (BT601_FULL if full_range else BT601_LIMITED).items()}
    else:
        flags = bt709 if bt709 is not None else full
        b, dev = flags.shape[0], flags.device
        sel709 = bt709.long() if bt709 is not None else torch.zeros(b, dtype=torch.long, device=dev)
        selfull = full.long() if full is not None else torch.full((b,), int(full_range), device=dev)
        idx = (sel709 + 2 * selfull).to(y_u8.device)
        shape = (b,) + (1,) * (yf.dim() - 1)
        c = {k: torch.tensor([s[k] for s in COLOR_SETS], dtype=torch.float32,
                             device=y_u8.device)[idx].reshape(shape) for k in BT601_LIMITED}
    yy = c["ky"] * (yf - c["y_off"])
    r = yy + c["rv"] * vf
    g = yy + c["gu"] * uf + c["gv"] * vf
    b = yy + c["bu"] * uf
    rgb = torch.stack([r, g, b], dim=-1) / 255.0
    return torch.clamp(rgb, 0.0, 1.0).to(out_dtype)


def packed_row_bytes(h: int, w: int) -> int:
    """Bytes of one frame's [Y | U | V] planes, without the tag byte."""
    return h * w + 2 * (h // 2) * (w // 2)


def unpack_yuv(packed: torch.Tensor, yuv_hw: tuple[int, int]):
    """(B, T, L) packed rows -> (y, u, v, bt709, full): the planes as views and the
    per-clip flags of the tag byte on each clip's first frame (None for rows without
    one). Raises ValueError on any other row length."""
    h, w = yuv_hw
    b, t, length = packed.shape
    yb, cb = h * w, (h // 2) * (w // 2)
    if length == yb + 2 * cb:
        bt709 = full = None
    elif length == yb + 2 * cb + 1:
        tag = packed[:, 0, -1]
        bt709, full = (tag & 1) > 0, (tag & 2) > 0
    else:
        raise ValueError(f"packed yuv row is {length} bytes; expected {yb + 2 * cb} (plain) or "
                         f"{yb + 2 * cb + 1} (+tag byte) for {tuple(yuv_hw)}")
    y = packed[..., :yb].reshape(b, t, h, w)
    u = packed[..., yb : yb + cb].reshape(b, t, h // 2, w // 2)
    v = packed[..., yb + cb : yb + 2 * cb].reshape(b, t, h // 2, w // 2)
    return y, u, v, bt709, full


# Compile-time taps of csrc/preprocess_yuv.cu (its K3_CASE table): (luma rows, luma
# columns per run, chroma rows, chroma columns per run) of the serving frame (240x320
# into 224x224). Other frames take the runtime-taps instantiation.
K3_TAPS = ((2, 12, 2, 8),)
K3_BANDS = (32, 16, 8, 4, 2, 1)  # output rows per block, largest first
K3_SMEM_TARGET = 48 * 1024  # bands are cut until a block's rows fit this, where they can


class K3Plane(NamedTuple):
    """One plane's tables and staging geometry (luma, or the chroma planes' shared ones)."""
    col0: int  # first window column; the kernel stages [col0, col0 + n_cols)
    n_cols: int
    ky: int  # rows per output row as launched
    span: int  # columns per run of K1_RUN outputs as launched
    vstart: np.ndarray  # (out_h,) int32
    vw: np.ndarray  # (out_h, ky) float32
    xs: np.ndarray  # (runs,) int32, from col0
    wrun: np.ndarray  # (runs, span, K1_RUN) float32
    pitch: int  # bytes per staged row


class K3Plan(NamedTuple):
    """How K3 runs one frame size, as csrc/preprocess_yuv.cu lays it out."""
    kernel: str  # "K3<KY, SPAN, KYC, SPANC>" or "K3<runtime>"
    static: bool
    runs: int
    band_rows: int
    n_bands: int
    luma: K3Plane
    chroma: K3Plane
    rows_buf: tuple[int, int]  # staged rows per band: luma, chroma (each of U and V)
    smem_bytes: int
    key: tuple  # (h, w, out_h, out_w, cropping_factor)


def _plane_taps(ry: np.ndarray, rx: np.ndarray) -> tuple[int, int, int, int, np.ndarray]:
    """(rows per output row, columns per run, col0, n_cols, band starts of R_x) of one
    plane's matrices."""
    out_w = rx.shape[0]
    xstart, xw = band(rx)
    kx = xw.shape[1]
    span = max(int(xstart[min(o + K1_RUN, out_w) - 1]) + kx - int(xstart[o])
               for o in range(0, out_w, K1_RUN))
    col0 = int(xstart.min())
    return band(ry)[1].shape[1], span, col0, int(xstart.max()) + kx - col0, xstart


def _plane(ry, rx, ky: int, span: int) -> K3Plane:
    _, _, col0, n_cols, _ = _plane_taps(ry, rx)
    vstart, vw = _row_bands(ry, ky)
    xs, wrun = _run_tiles(rx, span)
    pitch = _cdiv(15 + max(n_cols, int(xs.max()) + span), 16) * 16
    return K3Plane(col0, n_cols, ky, span, vstart, vw, xs, wrun, pitch)


def _rows_buf(vstart: np.ndarray, ky: int, rows: int) -> int:
    out_h = len(vstart)
    return max(int(vstart[min(o + rows, out_h) - 1]) + ky - int(vstart[o])
               for o in range(0, out_h, rows))


@functools.lru_cache(maxsize=16)
def k3_plan(h: int, w: int, out_h: int = 224, out_w: int = 224,
            cropping_factor: float = 0.8) -> K3Plan:
    """K3's instantiation, tables and launch geometry for an h x w frame. The taps are
    the first K3_TAPS entry that holds both planes' bands and runs, else the runtime-taps
    instantiation; the band is the largest of K3_BANDS whose staged rows fit
    K3_SMEM_TARGET, else the largest that fits a block. Raises ValueError for a
    chroma-misaligned window or where nothing fits."""
    ry, rx, cry, crx = yuv_matrices(h, w, out_h, out_w, float(cropping_factor))
    ky, span = _plane_taps(ry, rx)[:2]
    kyc, spanc = _plane_taps(cry, crx)[:2]
    fits = [t for t in K3_TAPS if t[0] >= ky and t[1] >= span and t[2] >= kyc and t[3] >= spanc]
    if fits:
        (ky, span, kyc, spanc), static = fits[0], True
    else:
        ky, span, kyc, spanc, static = ky, _cdiv(span, 4) * 4, kyc, _cdiv(spanc, 4) * 4, False
    luma, chroma = _plane(ry, rx, ky, span), _plane(cry, crx, kyc, spanc)
    for limit in (K3_SMEM_TARGET, SMEM_PER_BLOCK):
        for rows in K3_BANDS:
            buf = (_rows_buf(luma.vstart, ky, rows), _rows_buf(chroma.vstart, kyc, rows))
            smem = buf[0] * luma.pitch + 2 * buf[1] * chroma.pitch
            if smem <= limit:
                name = f"K3<{ky}, {span}, {kyc}, {spanc}>" if static else "K3<runtime>"
                return K3Plan(name, static, len(luma.xs), rows, _cdiv(out_h, rows), luma, chroma,
                              buf, smem, (h, w, out_h, out_w, float(cropping_factor)))
    raise ValueError(f"fused_preprocess_yuv: a {h}x{w} frame does not fit the kernel's shared memory")


def _table_words(plan: K3Plan) -> tuple[np.ndarray, list[int]]:
    """The tables as one float32 word array, each segment a multiple of 4 words (16-byte
    aligned): per plane vstart, vw, xs (int32 bits), wrun. Returns (words, the eight
    word offsets)."""
    segs = []
    for pl in (plan.luma, plan.chroma):
        segs += [pl.vstart.view(np.float32), pl.vw.ravel(), pl.xs.view(np.float32), pl.wrun.ravel()]
    sizes = [_cdiv(len(s), 4) * 4 for s in segs]
    words = np.concatenate([np.pad(s, (0, n - len(s))) for s, n in zip(segs, sizes)])
    return words, [int(x) for x in np.cumsum([0] + sizes[:-1])]


@functools.lru_cache(maxsize=8)
def _device_tables(key: tuple, device: torch.device) -> tuple[torch.Tensor, tuple[int, ...]]:
    plan = k3_plan(*key)
    words, offsets = _table_words(plan)
    geom = [key[0], key[1], plan.runs, plan.band_rows]
    for q, pl in enumerate((plan.luma, plan.chroma)):
        geom += [pl.col0, pl.n_cols, pl.ky, pl.span, plan.rows_buf[q], pl.pitch,
                 *offsets[4 * q : 4 * q + 4]]
    return torch.from_numpy(words).to(device), tuple(geom)


@functools.cache
def _library():
    from ted_spad_tpu_torch.utils.cuda_build import load

    fn = load("preprocess_yuv").ted_preprocess_yuv
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.restype = i
    fn.argtypes = [p, ll, p, i, p, ll, i, i, i, i, i, p, i, i, p]
    return fn


def fused_preprocess_yuv(
    packed: torch.Tensor,
    yuv_hw: tuple[int, int],
    *,
    out_h: int = 224,
    out_w: int = 224,
    cropping_factor: float = 0.8,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, T, H*W*3/2 [+1]) packed [Y | U | V (| tag)] uint8 rows of ``yuv_hw`` frames
    -> (B, T, out_h, out_w, 3) RGB in [0, 1], ``out_dtype``; with the tag byte each
    clip converts with the colour set its first frame's tag selects (bit 0 BT.709, bit
    1 full range), without it every clip is BT.601 limited range.

    On CUDA this launches kernel K3 once on the current stream (output memory
    (frames, out_h, out_w, 3), as K1's); on the CPU it runs
    ``fused_preprocess_yuv_reference`` on the unpacked planes."""
    if packed.dtype != torch.uint8 or packed.dim() != 3:
        raise ValueError(f"fused_preprocess_yuv takes (B, T, L) uint8 rows, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_preprocess_yuv writes float32 or bfloat16, not {out_dtype}")
    h, w = yuv_hw
    y, u, v, bt709, full = unpack_yuv(packed, yuv_hw)  # checks the row length
    if packed.device.type == "cpu":
        return fused_preprocess_yuv_reference(y, u, v, out_h=out_h, out_w=out_w,
                                              cropping_factor=cropping_factor,
                                              out_dtype=out_dtype, bt709=bt709, full=full)
    if packed.device.type != "cuda":
        raise ValueError(f"fused_preprocess_yuv runs on cuda or cpu, not {packed.device}")
    if not packed.is_contiguous():
        raise ValueError("fused_preprocess_yuv needs a contiguous batch of packed rows")
    plan = k3_plan(h, w, out_h, out_w, float(cropping_factor))
    b, t, length = packed.shape
    if b * t * plan.n_bands >= 2**31:
        raise ValueError(f"fused_preprocess_yuv launches one block per frame and band: {b * t} "
                         f"frames x {plan.n_bands} bands exceed the grid's 2**31 - 1")
    out = torch.empty((b, t, out_h, out_w, 3), dtype=out_dtype, device=packed.device)
    tables, geom = _device_tables(plan.key, packed.device)
    geom_c = (ctypes.c_int * len(geom))(*geom)
    with torch.cuda.device(packed.device):
        err = _library()(packed.data_ptr(), packed.numel(), out.data_ptr(),
                         int(out_dtype == torch.bfloat16), tables.data_ptr(), length,
                         int(bt709 is not None), t, b * t, out_h, out_w, geom_c,
                         int(plan.static), plan.smem_bytes,
                         torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_preprocess_yuv: kernel launch failed with cudaError {err}")
    fused_preprocess_yuv.launches += 1
    return out


fused_preprocess_yuv.launches = 0
