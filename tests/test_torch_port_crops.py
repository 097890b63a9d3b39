"""Port parity of the crops the extraction stage takes (ops/augment.py and the crop
windows of ops/preprocess.py) against ted_spad_tpu/ops/augment.py, and kernel K1's
tables for a window and a mirror on the CPU.

- ``center_crop_resize`` (hflip, ``no_ar_distortion``) and ``multi_crop_resize``
  (5, 10; torchvision's order, the ten-crop's mirrored five in the order
  [1, 0, 3, 2, 4]) against JAX within 1e-5 in float32, and the matrix form
  (``fused_preprocess_reference`` with the same crops) within 1e-5 of JAX too.
- K1 over crops: the planned window's tables shifted by each crop's offset and stored
  mirrored, through the byte-level emulation of csrc/preprocess.cu
  (``test_torch_port_preprocess_plan.emulate_k1``), against the plain version within
  1e-5.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_port_preprocess_plan import emulate_k1
from ted_spad_tpu.ops import augment as jax_augment
from ted_spad_tpu_torch.ops import augment
from ted_spad_tpu_torch.ops import preprocess as pp

torch.set_num_threads(1)

ATOL = 1e-5  # float32 rounding on [0, 1] images
SHAPES = [(2, 3, 60, 80, 3), (1, 2, 61, 83, 3), (1, 2, 240, 320, 3)]


def _clips(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[2]}x{s[3]}")
@pytest.mark.parametrize("hflip", [False, True])
@pytest.mark.parametrize("no_ar", [False, True])
def test_center_crop_resize_matches_jax(shape, hflip, no_ar):
    clips = _clips(shape, 1)
    ref = np.asarray(jax_augment.center_crop_resize(jnp.asarray(clips), 0.8, 56, 48, hflip=hflip,
                                                    no_ar_distortion=no_ar))
    ours = augment.center_crop_resize(torch.from_numpy(clips), 0.8, 56, 48, hflip=hflip,
                                      no_ar_distortion=no_ar).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    crop = pp.center_crop(*shape[2:4], 0.8, square=no_ar)._replace(mirror=hflip)
    mat = pp.fused_preprocess_reference(torch.from_numpy(clips), out_h=56, out_w=48, crops=[crop],
                                        out_dtype=torch.float32)[:, 0].numpy()
    np.testing.assert_allclose(mat, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[2]}x{s[3]}")
@pytest.mark.parametrize("ncrops", [5, 10])
def test_multi_crop_resize_matches_jax(shape, ncrops):
    clips = _clips(shape, 2)
    ref = np.asarray(jax_augment.multi_crop_resize(jnp.asarray(clips), 0.8, 56, 48, ncrops))
    ours = augment.multi_crop_resize(torch.from_numpy(clips), 0.8, 56, 48, ncrops).numpy()
    assert ours.shape == shape[:1] + (ncrops,) + shape[1:2] + (56, 48, 3)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    mat = pp.fused_preprocess(torch.from_numpy(clips), out_h=56, out_w=48, out_dtype=torch.float32,
                              crops=pp.multi_crops(*shape[2:4], 0.8, ncrops)).numpy()
    np.testing.assert_allclose(mat, ref, atol=ATOL, rtol=0)


def test_ten_crop_order():
    """The mirrored five are the mirrored (tr, tl, br, bl, centre): crop 5 is the
    mirror of crop 1, not of crop 0 (a plain per-view flip would swap 5<->6, 7<->8)."""
    crops = pp.multi_crops(240, 320, 0.8, 10)
    assert [c.mirror for c in crops] == [False] * 5 + [True] * 5
    assert [c.window for c in crops[5:]] == [crops[i].window for i in (1, 0, 3, 2, 4)]
    assert crops[4] == pp.center_crop(240, 320, 0.8)
    with pytest.raises(ValueError, match="ncrops"):
        pp.multi_crops(240, 320, 0.8, 3)


def test_five_crop_corners_match_jax():
    clips = _clips((2, 4, 30, 40, 3), 3)
    ours = augment.five_crop_corners(torch.from_numpy(clips), 20, 24)
    ref = jax_augment.five_crop_corners(jnp.asarray(clips), 20, 24)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("h,w,out_h,out_w,kind,base", [
    (240, 320, 224, 224, 10, 0), (240, 320, 224, 224, 5, 1), (480, 856, 224, 224, 10, 3),
    (61, 83, 56, 44, 10, 5), (240, 320, 224, 224, "square", 0), (480, 856, 224, 224, "square", 2),
])
def test_emulated_kernel_over_crops_matches_the_plain_version(h, w, out_h, out_w, kind, base):
    """One plan, for the first crop's window; every other crop shifts its tables by
    its offset (csrc/preprocess.cu) and a mirrored one stores each run reversed."""
    crops = ([pp.center_crop(h, w, 0.8, square=True)] if kind == "square"
             else pp.multi_crops(h, w, 0.8, kind))
    plan = pp.k1_plan(h, w, out_h, out_w, window=crops[0].window)
    table = pp._crop_table(plan, h, w, crops)
    frame = _clips((h, w, 3), h + w + base)
    ref = pp.fused_preprocess_reference(torch.from_numpy(frame[None, None]), out_h=out_h,
                                        out_w=out_w, crops=crops, out_dtype=torch.float32)[0, :, 0]
    for c, (dy, dx, mirror) in enumerate(table):
        got = emulate_k1(frame, plan, out_h, out_w, base, int(dy), int(dx), bool(mirror))
        np.testing.assert_allclose(got, ref[c].numpy(), atol=ATOL, rtol=0)


def test_windowed_plan_reproduces_the_window_matrices():
    """k1_plan keyed by a window holds that window's R_y and R_x; the centre window is
    the default, so the serving plan is unchanged."""
    window = pp.center_crop(240, 320, 0.8, square=True).window
    assert window == (24, 64, 192, 192)
    plan = pp.k1_plan(240, 320, 224, 224, window=window)
    ry, rx = pp.window_matrices(240, 320, 224, 224, window)
    assert (plan.col0, plan.n_cols) == (int(np.flatnonzero(rx.any(axis=0))[0]), 192)
    dense_y = np.zeros_like(ry)
    for o, (s, wts) in enumerate(zip(plan.vstart, plan.vw)):
        dense_y[o, s : s + plan.ky] = wts[: ry.shape[1] - s]
    np.testing.assert_array_equal(dense_y, ry)
    assert pp.k1_plan(240, 320, 224, 224) is pp.k1_plan(240, 320, 224, 224, window=(24, 32, 192, 256))


def test_crop_table_refuses_what_one_launch_cannot_take():
    plan = pp.k1_plan(240, 320, 224, 224)
    centre = pp.center_crop(240, 320, 0.8)
    with pytest.raises(ValueError, match="share a size"):
        pp._crop_table(plan, 240, 320, [centre, pp.center_crop(240, 320, 0.8, square=True)])
    with pytest.raises(ValueError, match="outside"):
        pp._crop_table(plan, 240, 320, [centre, centre._replace(x0=100)])
    with pytest.raises(ValueError, match="crops"):
        pp.fused_preprocess(torch.zeros((1, 1, 16, 16, 3), dtype=torch.uint8), out_h=8, out_w=8,
                            crops=[pp.Crop(0, 0, 8, 8)] * (pp.K1_MAX_CROPS + 1))


def test_crop_limit_mirrors_the_kernel_source():
    src = os.path.join(os.path.dirname(pp.__file__), os.pardir, "csrc", "preprocess.cu")
    with open(src) as f:
        text = f.read()
    assert int(re.search(r"constexpr int kMaxCrops = (\d+);", text).group(1)) == pp.K1_MAX_CROPS
    assert pp.K1_MAX_CROPS <= 32  # one bit of the mirror mask per crop
