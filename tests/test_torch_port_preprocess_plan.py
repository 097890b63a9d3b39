"""K1's plan (ops/preprocess.py:k1_plan) on the CPU: the instantiation and shared
memory each shape gets, the padded band tables against the dense resample matrices,
the staged rows each band needs, a numpy emulation of the kernel's decomposition
(staged aligned rows, word reads with a funnel shift, runs of 8 outputs, padded taps,
vertical then horizontal in float32) against the plain version, and the plan's
mirror of the kernel source's dispatch table."""

import itertools
import os
import re

import numpy as np
import pytest
import torch

from ted_spad_tpu_torch.ops import preprocess as pp

torch.set_num_threads(1)

# (H, W, out_h, out_w) -> the instantiation the plan must pick.
SHAPES = {
    (240, 320, 224, 224): "K1<2, 12>",   # the serving shape
    (480, 856, 224, 224): "K1<4, 32>",   # ShanghaiTech's frame: pitch 2,568 B, window at 258 B
    (1080, 1920, 224, 224): "K1<8, 64>",
    (360, 640, 224, 224): "K1<4, 32>",
    (61, 83, 56, 40): "K1<4, 32>",       # ragged: f32 rows of 480 B, 5 runs of 8; 2 taps, 16 columns
}
RUNTIME_SHAPE = (200, 300, 16, 16)  # 10x downscale: 20+ taps, past every compile-time pair


def _params(shapes):
    return pytest.mark.parametrize("shape", list(shapes), ids=["x".join(map(str, s)) for s in shapes])


@_params(SHAPES)
def test_plan_picks_the_instantiation_and_fits(shape):
    plan = pp.k1_plan(*shape)
    assert plan.kernel == SHAPES[shape] and plan.static
    assert 0 < plan.smem_bytes <= pp.SMEM_PER_BLOCK
    assert plan.row_pitch % 16 == 0  # staged rows take 16-byte cp.async chunks
    assert plan.n_bands == -(-shape[2] // plan.band_rows)


def test_plan_at_the_serving_shape():
    """32-row bands: 29 staged rows of 800 B (768 window bytes and the shift and read
    slack) beside 14,000 B of tables, 37,200 B a block."""
    plan = pp.k1_plan(240, 320, 224, 224)
    assert (plan.band_rows, plan.n_bands, plan.rows_buf, plan.row_pitch) == (32, 7, 29, 800)
    assert (plan.col0, plan.n_cols, plan.runs, plan.span) == (32, 256, 28, 12)
    assert plan.smem_bytes == 4 * len(pp._table_words(plan)[0]) + 29 * 800 == 37_200


@pytest.mark.parametrize("shape,band_rows,blocks", [((240, 320, 224, 224), 32, 3),
                                                   ((480, 856, 224, 224), 8, 3),
                                                   ((1080, 1920, 224, 224), 8, 1)])
def test_plan_band_fits_three_blocks_to_an_sm_where_it_can(shape, band_rows, blocks):
    """The largest band whose block fits three to an SM, the 1 KB each block reserves
    counted (serving, 480x856), else the largest that fits one (1080x1920: 57.8 KB of
    tables at SPAN 64)."""
    plan = pp.k1_plan(*shape)
    assert (plan.band_rows, plan.blocks_per_sm) == (band_rows, blocks)
    per_block = plan.smem_bytes + pp.SMEM_RESERVED_PER_BLOCK
    assert (pp.K1_BLOCKS_PER_SM * per_block <= pp.SMEM_PER_SM) == (blocks == pp.K1_BLOCKS_PER_SM)


def test_plan_counts_on_one_block_where_the_registers_allow_one():
    """<8, 64> (87 registers) is planned one block per SM even where three would fit
    by shared memory: a narrow output, 256 columns into 40."""
    assert dict(((k, s), b) for k, s, b in pp.K1_TAPS)[(8, 64)] == 1
    plan = pp.k1_plan(240, 320, 224, 40)
    assert plan.kernel == "K1<8, 64>" and plan.blocks_per_sm == 1
    assert plan.smem_bytes + pp.SMEM_RESERVED_PER_BLOCK <= pp.SMEM_PER_SM // 3


def test_plan_takes_runtime_taps_beyond_the_table():
    plan = pp.k1_plan(*RUNTIME_SHAPE)
    assert plan.kernel == "K1<runtime>" and not plan.static
    assert plan.ky > max(t[0] for t in pp.K1_TAPS) and plan.span > max(t[1] for t in pp.K1_TAPS)
    assert plan.span % 4 == 0
    assert plan.smem_bytes == plan.rows_buf * plan.row_pitch  # its tables stay in device memory


@_params(list(SHAPES) + [RUNTIME_SHAPE])
def test_padded_tables_reproduce_the_matrices(shape):
    ry, rx = pp.preprocess_matrices(*shape, 0.8)
    plan = pp.k1_plan(*shape)
    dense_y = np.zeros_like(ry)
    for o, (s, wts) in enumerate(zip(plan.vstart, plan.vw)):
        for k, v in enumerate(wts):
            if v:
                dense_y[o, s + k] = v
    np.testing.assert_array_equal(dense_y, ry)
    dense_x = np.zeros_like(rx)
    for r, x in enumerate(plan.xs):
        for j, q in itertools.product(range(plan.span), range(pp.K1_RUN)):
            if plan.wrun[r, j, q]:
                dense_x[r * pp.K1_RUN + q, plan.col0 + x + j] = plan.wrun[r, j, q]
    np.testing.assert_array_equal(dense_x, rx)
    assert plan.vw.shape == (shape[2], plan.ky) and plan.wrun.shape == (plan.runs, plan.span, 8)


@_params(list(SHAPES) + [RUNTIME_SHAPE])
def test_staged_rows_cover_every_band(shape):
    """Each band's staged rows [r0, r0 + n_in) hold every input row its outputs weigh,
    the padded taps stay inside the stage buffer, and each run's word reads inside
    its row's pitch."""
    h, w, out_h, out_w = shape
    ry, _ = pp.preprocess_matrices(*shape, 0.8)
    plan = pp.k1_plan(*shape)
    for oy0 in range(0, out_h, plan.band_rows):
        last = min(oy0 + plan.band_rows, out_h) - 1
        r0 = plan.vstart[oy0]
        n_in = min(plan.vstart[last] + plan.ky, h) - r0
        used = np.flatnonzero(ry[oy0 : last + 1].any(axis=0))
        assert r0 <= used[0] and used[-1] < r0 + n_in
        assert plan.vstart[last] + plan.ky - r0 <= plan.rows_buf
    assert 15 + 3 * plan.n_cols <= plan.row_pitch  # the aligned superset of a row
    assert 19 + 3 * (int(plan.xs.max()) + plan.span) <= plan.row_pitch  # the last run's words


def emulate_k1(frame: np.ndarray, plan: pp.K1Plan, out_h: int, out_w: int, base: int,
               dy: int = 0, dx: int = 0, mirror: bool = False) -> np.ndarray:
    """csrc/preprocess.cu on one (H, W, 3) uint8 frame whose first byte lies at address
    ``base``: rows staged as 16-byte-aligned supersets (bytes outside the tensor read
    as 0, the rest of the buffer garbage), 4-byte words realigned by the row's shift,
    float32 vertical sums over the padded taps, then the run's dense weight tiles. A
    crop (``dy``, ``dx``, ``mirror``) shifts the planned window's rows and columns and
    stores each run reversed at the mirrored columns."""
    h, w, _ = frame.shape
    mem = frame.ravel()
    w3, chunks = 3 * w, (15 + 3 * plan.n_cols + 15) // 16
    rng = np.random.default_rng(7)
    out = np.zeros((out_h, out_w, 3), np.float32)
    lanes = np.arange(plan.runs)
    for oy0 in range(0, out_h, plan.band_rows):
        n_out = min(plan.band_rows, out_h - oy0)
        v0 = int(plan.vstart[oy0])
        r0 = v0 + dy
        n_in = min(int(plan.vstart[oy0 + n_out - 1]) + plan.ky + dy, h) - r0
        buf = rng.integers(0, 256, (plan.rows_buf, plan.row_pitch), dtype=np.uint8)
        first = base + r0 * w3 + (plan.col0 + dx) * 3
        for r in range(n_in):
            a0 = (first + r * w3) & ~15
            addr = a0 + np.arange(16 * chunks)
            inside = (addr >= base) & (addr < base + mem.size)
            buf[r, : 16 * chunks] = np.where(inside, mem[np.clip(addr - base, 0, mem.size - 1)], 0)
        for oy in range(oy0, oy0 + n_out):
            vs = int(plan.vstart[oy]) - v0
            acc = np.zeros((plan.runs, pp.K1_RUN, 3), np.float32)
            for g in range(plan.span // 4):
                v = np.zeros((plan.runs, 12), np.float32)
                for k in range(plan.ky):
                    rr = vs + k
                    off = ((first + rr * w3) & 15) + 3 * plan.xs
                    words = (off & ~3) + 12 * g
                    assert words.max() + 16 <= plan.row_pitch and rr < plan.rows_buf
                    raw = buf[rr][words[:, None] + np.arange(16)]
                    byte = raw[lanes[:, None], (off & 3)[:, None] + np.arange(12)]
                    v = (v + np.float32(plan.vw[oy, k]) * byte.astype(np.float32)).astype(np.float32)
                for jj in range(4):
                    wx = plan.wrun[:, 4 * g + jj, :]  # (runs, 8)
                    acc = (acc + wx[:, :, None] * v[:, None, 3 * jj : 3 * jj + 3]).astype(np.float32)
            row = acc.reshape(-1, 3)[:out_w]
            out[oy] = row[::-1] if mirror else row
    return out


@pytest.mark.parametrize("shape,base", [((240, 320, 224, 224), 0), ((240, 320, 224, 224), 1),
                                        ((480, 856, 224, 224), 0), ((1080, 1920, 224, 224), 3),
                                        ((360, 640, 224, 224), 0), ((61, 83, 56, 40), 5),
                                        (RUNTIME_SHAPE, 1)])
def test_emulated_kernel_matches_the_plain_version(shape, base):
    h, w, out_h, out_w = shape
    frame = np.random.default_rng(sum(shape) + base).integers(0, 256, (h, w, 3), dtype=np.uint8)
    got = emulate_k1(frame, pp.k1_plan(*shape), out_h, out_w, base)
    ref = pp.fused_preprocess_reference(torch.from_numpy(frame[None, None]), out_h=out_h,
                                        out_w=out_w, out_dtype=torch.float32)[0, 0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def _old_kernel_fits(h, w, out_h, out_w):
    """Whether the first K1 design (one 8-to-1-row tile per block, an f32 vertical
    tile beside the staged rows) took a shape."""
    ry, rx = pp.preprocess_matrices(h, w, out_h, out_w, 0.8)
    ys, yw = pp.band(ry)
    xst, xw = pp.band(rx)
    n_cols = int(xst.max()) + xw.shape[1] - int(xst.min())
    for tile in (8, 4, 2, 1):
        rows = max(int(ys[min(o + tile, out_h) - 1]) + yw.shape[1] - int(ys[o])
                   for o in range(0, out_h, tile))
        if tile * n_cols * 12 + rows * n_cols * 3 <= 227 * 1024:
            return True
    return False


@pytest.mark.parametrize("shape", [(2160, 3840, 224, 224), (1080, 1920, 112, 112), (720, 1280, 56, 40),
                                   (4000, 1920, 224, 224), (720, 1280, 448, 448), (16, 16, 224, 224), (3, 5, 7, 9),
                                   (480, 8000, 224, 224)])
def test_every_shape_the_first_design_took_is_taken(shape):
    assert _old_kernel_fits(*shape)
    plan = pp.k1_plan(*shape)
    assert plan.smem_bytes <= pp.SMEM_PER_BLOCK


def test_every_shape_of_a_grid_the_first_design_took_is_taken():
    """Frames from 16x16 to 2160x3840 into four output sizes: every shape the first
    design took (140 of the 144), the plan takes."""
    grid = itertools.product((16, 61, 240, 480, 1080, 2160), (16, 83, 320, 856, 1920, 3840),
                             ((224, 224), (112, 112), (56, 40), (448, 448)))
    taken = [(h, w, oh, ow) for h, w, (oh, ow) in grid if _old_kernel_fits(h, w, oh, ow)]
    assert len(taken) > 130
    for shape in taken:
        assert pp.k1_plan(*shape).smem_bytes <= pp.SMEM_PER_BLOCK


def test_plan_refuses_a_row_wider_than_shared_memory():
    with pytest.raises(ValueError, match="shared"):
        pp.k1_plan(16, 200_000, 8, 8)


def test_plan_mirrors_the_kernel_source():
    src = os.path.join(os.path.dirname(pp.__file__), os.pardir, "csrc", "preprocess.cu")
    with open(src) as f:
        text = f.read()
    cases = {tuple(map(int, m)) for m in re.findall(r"K1_CASE\((\d+), (\d+)\)\s", text)}
    assert cases == {(k, s) for k, s, _ in pp.K1_TAPS}
    assert int(re.search(r"constexpr int kRun = (\d+);", text).group(1)) == pp.K1_RUN
    assert all(s % 4 == 0 for _, s, _ in pp.K1_TAPS)  # the kernel reads columns in groups of 4
