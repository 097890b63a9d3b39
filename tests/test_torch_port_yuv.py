"""Port parity for YUV420 planar ingest: ``ted_spad_tpu_torch.ops.yuv`` (the plain
``fused_preprocess_yuv`` and the plan of kernel K3), the port's ``read_strided_yuv`` and
the extraction stage's ``decode_mode="yuv"`` against ``ted_spad_tpu.ops.yuv``,
``ted_spad_tpu.data.video_reader`` and ``ted_spad_tpu.stages.feature_extraction``, on the
CPU in float32.

Tolerances: the plain preprocess within 1e-5 of max|out| (float32 matmul order); the
packed rows byte-equal; a numpy emulation of K3 from its plan (tables, staged rows,
vertical then horizontal passes) within 1e-5 of max|plain| over a grid of frame sizes;
the extracted features within 1e-4 of max|feat|."""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ted_spad_tpu.stages.feature_extraction as jax_fe
from ted_spad_tpu.config.params import FeatureExtractionParams as JaxFeatureExtractionParams
from ted_spad_tpu.data.video_reader import native_available, write_mp4, write_y4m
from ted_spad_tpu.models import load_fa_model as jax_load_fa
from ted_spad_tpu.models import load_ft_model as jax_load_ft
from ted_spad_tpu.ops.yuv import fused_preprocess_yuv as jax_fused_preprocess_yuv
from ted_spad_tpu_torch.config.params import FeatureExtractionParams
from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
from ted_spad_tpu_torch.ops import yuv
from ted_spad_tpu_torch.stages import feature_extraction as fe
from ted_spad_tpu_torch.utils.jax_weights import FT_HEADS, load_jax_variables

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
URIS = [f"synthetic://n={n},h=40,w=80,seed={s}" for n, s in ((60, 0), (40, 1001), (10, 2))]
RTOL = 1e-5
FEAT_RTOL = 1e-4


def _rows(b, t, h, w, tagged, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (b, t, yuv.packed_row_bytes(h, w) + int(tagged)), dtype=np.uint8)
    if tagged:
        rows[:, :, -1] = (np.arange(b) % 4)[:, None]  # all four colour sets in one batch
    return rows


def _jax_plain(rows, hw, **kw):
    y, u, v, bt709, full = yuv.unpack_yuv(torch.from_numpy(rows), hw)
    flags = {} if bt709 is None else dict(bt709=jnp.asarray(bt709.numpy()),
                                          full=jnp.asarray(full.numpy()))
    return np.asarray(jax_fused_preprocess_yuv(jnp.asarray(y.numpy()), jnp.asarray(u.numpy()),
                                               jnp.asarray(v.numpy()), out_dtype=jnp.float32,
                                               **flags, **kw))


@pytest.mark.parametrize("tagged", [False, True])
@pytest.mark.parametrize("hw,out", [((40, 80), (32, 32)), ((48, 64), (24, 40))])
def test_plain_yuv_preprocess_matches_jax(tagged, hw, out):
    rows = _rows(4, 3, *hw, tagged, seed=hw[0] + tagged)
    kw = dict(out_h=out[0], out_w=out[1], cropping_factor=0.8 if hw[0] == 40 else 0.75)
    want = _jax_plain(rows, hw, **kw)
    got = yuv.fused_preprocess_yuv(torch.from_numpy(rows), hw, out_dtype=torch.float32, **kw)
    assert got.shape == want.shape == (4, 3, *out, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=RTOL * np.abs(want).max(), rtol=0)
    if tagged:  # the four rows really convert with four different sets
        plain601 = yuv.fused_preprocess_yuv(torch.from_numpy(rows[..., :-1].copy()), hw,
                                            out_dtype=torch.float32, **kw)
        assert torch.equal(got[0], plain601[0])
        assert all(not torch.equal(got[i], plain601[i]) for i in (1, 2, 3))


def test_plain_yuv_full_range_flag_matches_jax():
    rows = _rows(2, 2, 40, 80, False, seed=9)
    y, u, v, _, _ = yuv.unpack_yuv(torch.from_numpy(rows), (40, 80))
    got = yuv.fused_preprocess_yuv_reference(y, u, v, out_h=32, out_w=32, out_dtype=torch.float32,
                                             full_range=True)
    want = jax_fused_preprocess_yuv(*(jnp.asarray(t.numpy()) for t in (y, u, v)), out_h=32,
                                    out_w=32, out_dtype=jnp.float32, full_range=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RTOL, rtol=0)


# One decode worker: batches then pack videos in submission order in both packages.
def _jax_batches(uris, p, bs, hw):
    return list(jax_fe.iter_clip_batches(uris, p, bs, decode_hw=hw, num_workers=1,
                                         decode_mode="yuv"))


def _port_batches(uris, p, bs, hw):
    return list(fe.iter_clip_batches(uris, p, bs, decode_hw=hw, num_workers=1, decode_mode="yuv"))


def _same_batches(ours, want):
    assert len(ours) == len(want) > 0
    for (c, r, n), (jc, jr, jn) in zip(ours, want):
        assert c.dtype == np.uint8 and c.shape == jc.shape
        np.testing.assert_array_equal(c, jc)
        assert [(x.video_idx, x.clip_idx) for x in r] == [(x.video_idx, x.clip_idx) for x in jr]
        assert n == jn


def test_packed_rows_match_jax_on_synthetic_videos():
    common = dict(num_frames=8, fix_skip=2)
    ours = _port_batches(URIS, FeatureExtractionParams(**common), 4, (40, 80))
    want = _jax_batches(URIS, JaxFeatureExtractionParams(**common), 4, (40, 80))
    _same_batches(ours, want)
    assert ours[0][0].shape == (4, 8, 40 * 80 * 3 // 2 + 1)


def _chroma_rich_frames(n, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    frames = [np.stack([(xx * 7 + i * 5) % 256, (yy * 11 + i * 3) % 256,
                        ((xx + yy) * 5 + i * 9) % 256], axis=-1) for i in range(n)]
    return np.asarray(frames, np.uint8)


@pytest.mark.skipif(not native_available(), reason="native videodec unavailable")
def test_packed_rows_match_jax_on_native_reads(tmp_path):
    """The native decoder's planar reads through both bindings: a full-range Y4M (tag bit
    1) and a BT.709 mp4 (bit 0), packed into one run's batches."""
    frames = _chroma_rich_frames(40, 40, 80)
    uris = [write_y4m(str(tmp_path / "full.y4m"), frames),
            write_mp4(str(tmp_path / "v709.mp4"), frames, codec="libx264", colorspace=709)]
    common = dict(num_frames=8, fix_skip=2)
    ours = _port_batches(uris, FeatureExtractionParams(**common), 2, (40, 80))
    _same_batches(ours, _jax_batches(uris, JaxFeatureExtractionParams(**common), 2, (40, 80)))
    tags = {int(t) for c, _, _ in ours for t in c[:, 0, -1]}
    assert tags == {1, 2}


def test_kernel_table_mirror():
    """ops/yuv.py's K3_TAPS is csrc/preprocess_yuv.cu's K3_CASE table."""
    with open(os.path.join(ROOT, "ted_spad_tpu_torch", "csrc", "preprocess_yuv.cu")) as f:
        src = f.read()
    table = re.findall(r"^\s*K3_CASE\((\d+), (\d+), (\d+), (\d+)\)", src, flags=re.M)
    assert tuple(tuple(int(v) for v in t) for t in table) == yuv.K3_TAPS


def emulate_k3(rows: np.ndarray, hw, out_h: int, out_w: int, cf: float) -> np.ndarray:
    """K3 in numpy from its plan, as the kernel reads its tables: per block (frame, band)
    the band's staged rows of each plane (window columns from col0), per run of 8 outputs
    the vertical pass over KY staged rows for each of the SPAN columns (rows past the
    plane read as 0: their weights are 0), the horizontal pass through the run's dense
    tile, then the colour set of the clip's first-frame tag, /255 and the clip."""
    h, w = hw
    plan = yuv.k3_plan(h, w, out_h, out_w, cf)
    b, t, length = rows.shape
    tagged = length == yuv.packed_row_bytes(h, w) + 1
    out = np.zeros((b, t, out_h, out_w, 3), np.float32)
    planes = {0: (0, h, w), 1: (h * w, h // 2, w // 2), 2: (h * w + (h // 2) * (w // 2), h // 2, w // 2)}
    for bi in range(b):
        set_ = 0
        if tagged:
            tag = int(rows[bi, 0, -1])
            set_ = (tag & 1) + 2 * ((tag >> 1) & 1)
        c = yuv.COLOR_SETS[set_]
        for ti in range(t):
            row = rows[bi, ti]
            res = {}
            for q, (off, ph, pw) in planes.items():
                pl = plan.luma if q == 0 else plan.chroma
                img = row[off : off + ph * pw].reshape(ph, pw).astype(np.float32)
                acc = np.zeros((out_h, plan.runs * 8), np.float32)
                for band0 in range(0, out_h, plan.band_rows):
                    r0 = int(pl.vstart[band0])
                    staged = np.zeros((plan.rows_buf[0 if q == 0 else 1], pl.pitch), np.float32)
                    n_in = min(int(pl.vstart[min(band0 + plan.band_rows, out_h) - 1]) + pl.ky, ph) - r0
                    cols = min(pl.pitch, pw - pl.col0)
                    staged[:n_in, :cols] = img[r0 : r0 + n_in, pl.col0 : pl.col0 + cols]
                    for oy in range(band0, min(band0 + plan.band_rows, out_h)):
                        vs = int(pl.vstart[oy]) - r0
                        for run in range(plan.runs):
                            x = int(pl.xs[run])
                            vert = (pl.vw[oy][:, None] * staged[vs : vs + pl.ky, x : x + pl.span]).sum(0)
                            acc[oy, run * 8 : run * 8 + 8] = vert @ pl.wrun[run]
                res[q] = acc[:, :out_w]
            yy = c["ky"] * (res[0] - c["y_off"])
            uf, vf = res[1] - 128.0, res[2] - 128.0
            rgb = np.stack([yy + c["rv"] * vf, yy + c["gu"] * uf + c["gv"] * vf, yy + c["bu"] * uf], -1)
            out[bi, ti] = np.clip(rgb / 255.0, 0.0, 1.0)
    return out


@pytest.mark.parametrize("hw,out,cf", [
    ((240, 320), (224, 224), 0.8),   # the serving frame: K3<2, 12, 2, 8>
    ((40, 80), (32, 32), 0.8),       # the CLIs' synthetic frame
    ((480, 856), (224, 224), 0.8),   # ShanghaiTech's native frame: runtime taps
    ((64, 96), (56, 40), 0.75),      # ragged output runs
    ((120, 160), (24, 24), 0.8),     # a 5x downscale: long runs
])
def test_k3_plan_emulation_matches_plain(hw, out, cf):
    rows = _rows(2, 1, *hw, tagged=True, seed=sum(hw))
    plan = yuv.k3_plan(*hw, *out, cf)
    assert plan.smem_bytes <= yuv.SMEM_PER_BLOCK
    got = emulate_k3(rows, hw, *out, cf)
    want = yuv.fused_preprocess_yuv(torch.from_numpy(rows), hw, out_h=out[0], out_w=out[1],
                                    cropping_factor=cf, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=RTOL * np.abs(want).max(), rtol=0)
    if hw == (240, 320):
        assert plan.kernel == "K3<2, 12, 2, 8>" and plan.static
    if hw == (480, 856):
        assert plan.kernel == "K3<runtime>"


def _perturbed(variables, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32) * rng.uniform(0.8, 1.2, np.shape(x))
                   + 0.05 * rng.standard_normal(np.shape(x))).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, variables))


def test_extract_features_yuv_matches_jax(tmp_path, monkeypatch):
    fa_model, fa_vars = jax_load_fa(image_size=(32, 32), dtype="float32", tiny=True)
    ft_model, ft_vars = jax_load_ft(clip_shape=(8, 32, 32), dtype="float32", tiny=True)
    fa_vars, ft_vars = _perturbed(fa_vars, 0), _perturbed(ft_vars, 1)
    monkeypatch.setattr(jax_fe, "load_fa_model", lambda *a, **k: (fa_model, fa_vars))
    monkeypatch.setattr(jax_fe, "load_ft_model", lambda *a, **k: (ft_model, ft_vars))
    common = dict(num_frames=8, fix_skip=2, batch_size=4, reso_h=32, reso_w=32,
                  compute_dtype="float32")
    ref = jax_fe.extract_features(JaxFeatureExtractionParams(**common), URIS, str(tmp_path / "jax"),
                                  decode_hw=(40, 80), num_workers=2, decode_mode="yuv",
                                  log_fn=lambda s: None)
    fa = load_jax_variables(load_fa_model(tiny=True, dtype="float32", device="cpu"), fa_vars)
    ft = load_jax_variables(load_ft_model(tiny=True, dtype="float32", device="cpu"), ft_vars,
                            skip=FT_HEADS)
    ours = fe.extract_features(FeatureExtractionParams(**common), URIS, str(tmp_path / "port"),
                               fa=fa, ft=ft, decode_hw=(40, 80), num_workers=2, device="cpu",
                               decode_mode="yuv", log_fn=lambda s: None)
    assert ours["clips"] == ref["clips"] == 6
    for uri, path in ours["saved"].items():
        got, want = np.load(path), np.load(ref["saved"][uri])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=FEAT_RTOL * np.abs(want).max(), rtol=0)


def test_yuv_refusals(tmp_path, monkeypatch):
    p = FeatureExtractionParams(num_frames=8, reso_h=32, reso_w=32, compute_dtype="float32",
                                anonymized=False)
    ft = load_ft_model(tiny=True, dtype="float32", device="cpu")
    # A chroma-misaligned crop window: 0.8 of 50 rows starts at row 5.
    with pytest.raises(ValueError, match="chroma-misaligned"):
        yuv.fused_preprocess_yuv(torch.from_numpy(_rows(1, 1, 50, 64, True)), (50, 64))
    # A row of another length.
    with pytest.raises(ValueError, match="packed yuv row"):
        yuv.fused_preprocess_yuv(torch.zeros((1, 1, 99), dtype=torch.uint8), (40, 80))
    # no_ar_distortion and ncrops > 1.
    with pytest.raises(ValueError, match="no_ar_distortion"):
        fe.extract_features(p.replace(no_ar_distortion=True), URIS, str(tmp_path), ft=ft,
                            decode_hw=(40, 80), device="cpu", decode_mode="yuv")
    with pytest.raises(ValueError, match="no_ar_distortion"):
        fe.make_extract_step(ft, p.replace(no_ar_distortion=True), device="cpu", yuv=True)
    with pytest.raises(ValueError, match="ncrops"):
        fe.make_extract_step(ft, p.replace(ncrops=5), device="cpu", yuv=True)
    # An unsupported colorspace, and a native size other than decode_hw.
    real_open = fe.open_video

    def open_2020(uri, *a, **k):
        vr = real_open(uri, *a, **k)
        vr.colorspace = -1  # BT.2020 and the like
        return vr

    monkeypatch.setattr(fe, "open_video", open_2020)
    with pytest.raises(RuntimeError, match="colorspace tag -1"):
        next(fe.iter_clip_batches(URIS[:1], p, 2, decode_hw=(40, 80), decode_mode="yuv"))
    skipped = {}
    batches = list(fe.iter_clip_batches(URIS[:1], p, 2, decode_hw=(40, 80), decode_mode="yuv",
                                        on_error=lambda vi, e: skipped.update({vi: e})))
    assert not batches and "colorspace" in skipped[0]
    monkeypatch.setattr(fe, "open_video", real_open)
    with pytest.raises(RuntimeError, match="native size"):
        next(fe.iter_clip_batches(URIS[:1], p, 2, decode_hw=(48, 80), decode_mode="yuv"))
