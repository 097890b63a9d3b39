"""K2's float32 form on the CPU, before any card time: its plan (ops/doubleconv.py:
k2_f32_plan) against the constants of csrc/doubleconv.cu, the shared memory it plans
within a block's 232,448 B and for three blocks an SM, and a torch emulation of the kernel's tiling -- pixels
flattened over frames into BM-pixel tiles, the 9-tap gather masked by each pixel's own
frame, K ordered (chunk of BK channels, tap) on the 16-byte path and row by row on the
4-byte path, ragged M and N -- held against the plain version, which is held against
the JAX package's reference at the same shapes. Inputs from numpy seeds, float32, torch
on one thread; each tolerance is stated where it is used."""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ted_spad_tpu.ops import pallas_doubleconv as jdc
from ted_spad_tpu_torch.chip_probes import VIS_CHUNK, unet_doubleconv_shapes
from ted_spad_tpu_torch.ops import doubleconv as dc

torch.set_num_threads(1)

SOURCE = os.path.join(os.path.dirname(dc.__file__), os.pardir, "csrc", "doubleconv.cu")
FRAMES = ((2, 2), (5, 7), (17, 33))
# Cin 3 and 13 take the 4-byte path; Cmid 70 the wide tile, ragged in N and off the
# 16-byte path as pass 2's Cin; Cout 37 the narrow tile, ragged, with 4-byte B copies.
CHANNELS = ((3, 70, 37), (13, 36, 130), (64, 70, 37))
CASES = [(3, h, w, *c) for h, w in FRAMES for c in CHANNELS]
EMULATION_RTOL = 1e-5  # float32 summation order only
SMEM_PER_SM = 233_472  # an H100 SM's shared memory, 228 KB


def _operands(seed, n, h, w, cin, cmid, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, cin, cmid)) * (2.0 / (9 * cin)) ** 0.5).astype(np.float32)
    b1 = (rng.standard_normal(cmid) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, cmid, cout)) * (2.0 / (9 * cmid)) ** 0.5).astype(np.float32)
    b2 = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def emulate_pass(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 frame_masked: bool = True) -> torch.Tensor:
    """One pass of the float32 kernel, relu(conv3x3(x, w) + b), computed as the kernel
    tiles it: every stage gathers A (the BM-pixel tiles' BK k rows) and B (those k rows
    of the (9 Cin, Cout) weights, BN-column tiles) with the kernel's masks, and the
    tiles accumulate stage by stage. ``frame_masked=False`` masks a tap's row only by
    the flattened tensor's ends, so a frame's top and bottom taps read its neighbours'
    rows: the fault the kernel's per-frame mask prevents."""
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    m_total = n * h * wd
    p = dc.k2_f32_pass(m_total, cin, cout)
    bm, bn = map(int, p.tile.split("x"))
    bk = dc._K2_F32_BK
    gx, gy = p.grid
    m = torch.arange(gx * bm)
    r = m % (h * wd)
    y, xx = r // wd, r % wd
    xf = x.reshape(m_total, cin)
    wf = w.reshape(9 * cin, cout)
    cols = torch.arange(gy * bn)
    acc = torch.zeros(gx, bm, gy * bn)
    for s in range(p.k_stages):
        kk = torch.arange(bk)
        if p.copy_bytes == 16:  # one tap of one BK-channel chunk
            tap = torch.full((bk,), s % 9)
            c = s // 9 * bk + kk
            k_ok = c < cin
        else:  # the weight matrix's rows in order
            k = s * bk + kk
            tap, c = k // cin, k % cin
            k_ok = k < 9 * cin
        krow = tap * cin + c
        dy, dx = tap // 3 - 1, tap % 3 - 1
        yy, xs = y[:, None] + dy, xx[:, None] + dx
        src = m[:, None] + dy * wd + dx
        col_ok = (xs >= 0) & (xs < wd)
        row_ok = (yy >= 0) & (yy < h) if frame_masked else (src >= 0) & (src < m_total)
        ok = (m < m_total)[:, None] & row_ok & col_ok & k_ok
        a = torch.where(ok, xf[src.clamp(0, m_total - 1), c.clamp(max=cin - 1)], 0.0)
        b_ok = k_ok[:, None] & (cols < cout)
        bt = torch.where(b_ok, wf[krow.clamp(max=9 * cin - 1)][:, cols.clamp(max=cout - 1)], 0.0)
        acc += a.view(gx, bm, bk) @ bt
    out = torch.relu(acc.reshape(gx * bm, gy * bn) + torch.nn.functional.pad(b, (0, gy * bn - cout)))
    return out[:m_total, :cout].reshape(n, h, wd, cout)


def emulate(x, w1, b1, w2, b2, frame_masked: bool = True) -> torch.Tensor:
    """The float32 form: pass 1 into the scratch, pass 2 from it."""
    mid = emulate_pass(x, w1, b1, frame_masked)
    return emulate_pass(mid, w2, b2, frame_masked)


def _source() -> str:
    with open(SOURCE) as f:
        return f.read()


def test_plan_mirrors_the_kernel_source():
    src = _source()
    consts = dict(re.findall(r"constexpr int (BK|STAGES|THREADS|MIN_BLOCKS) = (\d+);", src))
    assert tuple(int(consts[k]) for k in ("BK", "STAGES", "THREADS", "MIN_BLOCKS")) == (
        dc._K2_F32_BK, dc._K2_F32_STAGES, dc._K2_F32_THREADS, dc._K2_F32_MIN_BLOCKS)
    assert re.search(r"__launch_bounds__\(THREADS, MIN_BLOCKS\)\s*\nconv3x3\(", src)
    assert re.search(r"constexpr int LDA = BK \+ 4;", src)
    tiles = dict((name.lower(), (int(bm), int(bn))) for name, bm, bn in
                 re.findall(r"using Tile(Wide|Narrow) = Tile<(\d+), (\d+)>;", src))
    assert tiles == dc._K2_F32_TILES
    assert re.search(rf"if \(cout <= {dc._K2_F32_NARROW_COUT}\)\s*\n\s*return "
                     r"launch_f32_pass<f32::TileNarrow>", src)


@pytest.mark.parametrize("name,h,w,cin,cmid,cout",
                         unet_doubleconv_shapes(*VIS_CHUNK[1:]),
                         ids=[s[0] for s in unet_doubleconv_shapes(*VIS_CHUNK[1:])])
def test_plan_at_the_visualization_chunk(name, h, w, cin, cmid, cout):
    n = VIS_CHUNK[0]
    plan = dc.k2_f32_plan(n, h, w, cin, cmid, cout)
    assert plan.scratch_bytes == n * h * w * cmid * 4
    for p, (ci, co) in zip(plan.passes, ((cin, cmid), (cmid, cout))):
        bm, bn = (128, 64) if co <= 64 else (64, 128)
        assert (p.cin, p.cout, p.tile) == (ci, co, f"{bm}x{bn}")
        assert p.grid == (-(-n * h * w // bm), -(-co // bn))
        assert p.smem_bytes == 3 * (bm * 20 + 16 * bn) * 4 <= dc.SMEM_PER_BLOCK
        assert 3 * (p.smem_bytes + 1024) <= SMEM_PER_SM  # three blocks an SM, 1 KB each reserved
        assert (p.stages, p.threads) == (3, 128)
        assert p.k_stages == (9 * -(-ci // 16) if ci % 4 == 0 else -(-9 * ci // 16))
        assert p.copy_bytes == (16 if ci % 4 == 0 else 4)
    if name == "inc":  # Cin 3: 27 k rows in 2 stages of 4-byte copies
        assert plan.passes[0].k_stages == 2 and plan.passes[0].copy_bytes == 4


def test_plan_refuses_what_the_index_arithmetic_cannot_hold():
    with pytest.raises(ValueError, match="positive"):
        dc.k2_f32_plan(1, 0, 8, 3, 8, 8)
    with pytest.raises(ValueError, match="32768"):
        dc.k2_f32_plan(1, 40000, 8, 3, 8, 8)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        dc.k2_f32_plan(30000, 300, 300, 3, 8, 8)


@pytest.mark.parametrize("shape", CASES, ids=["x".join(map(str, c)) for c in CASES])
def test_emulated_tiling_matches_the_plain_version(shape):
    """Within 1e-5 of max|plain|; the plain version itself within 1e-5 of the JAX
    package's reference at the same shape."""
    args = _operands(sum(shape), *shape)
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args)
    ref = dc.double_conv_reference(x, w1, b1, w2, b2)
    got = emulate(x, w1, b1, w2, b2)
    scale = float(ref.abs().max())
    assert got.shape == ref.shape and scale > 0
    assert float((got - ref).abs().max()) <= EMULATION_RTOL * scale
    jax_ref = np.asarray(jdc.double_conv_reference(*(jnp.asarray(a) for a in args)))
    assert float(np.abs(ref.numpy() - jax_ref).max()) <= EMULATION_RTOL * scale


@pytest.mark.parametrize("frame", FRAMES, ids=["x".join(map(str, f)) for f in FRAMES])
def test_emulation_without_the_frame_mask_fails(frame):
    """The check above is able to see a tap that reads the neighbouring frame: masked
    only by the tensor's ends, the same emulation misses by far more than its limit."""
    shape = (3, *frame, *CHANNELS[2])
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _operands(sum(shape), *shape))
    ref = dc.double_conv_reference(x, w1, b1, w2, b2)
    leaky = emulate(x, w1, b1, w2, b2, frame_masked=False)
    assert float((leaky - ref).abs().max()) > 100 * EMULATION_RTOL * float(ref.abs().max())
