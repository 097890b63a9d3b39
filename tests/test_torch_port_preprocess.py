"""Port parity: ted_spad_tpu_torch/ops/preprocess.py (kernel K1's module) and
ops/augment.py against the JAX package's preprocess.

Inputs come from numpy with a seed and go through both packages; JAX's Pallas
kernel runs in interpret mode on the CPU. Tolerance 1e-5 absolute on [0, 1]
images, as tests/test_pallas_preprocess.py: both sides accumulate in float32 over
a few taps, so they differ by float32 rounding only."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ted_spad_tpu.ops.augment import center_crop_resize as jax_center_crop_resize
from ted_spad_tpu.ops.pallas_preprocess import fused_preprocess as jax_fused_preprocess
from ted_spad_tpu.ops.pallas_preprocess import resize_matrix as jax_resize_matrix
from ted_spad_tpu_torch.ops import preprocess as pp
from ted_spad_tpu_torch.ops.augment import center_crop_resize

torch.set_num_threads(1)

ATOL = 1e-5  # float32 rounding on [0, 1] images


@pytest.mark.parametrize("src,dst,crop_start,crop_size", [
    (240, 224, 24, 192), (320, 224, 32, 256), (48, 56, 0, None), (61, 56, 6, 48), (83, 40, 8, 66),
])
def test_resize_matrix_identical_to_jax(src, dst, crop_start, crop_size):
    ours = pp.resize_matrix(src, dst, crop_start, crop_size, scale_gain=1.0 / 255.0)
    ref = jax_resize_matrix(src, dst, crop_start, crop_size, scale_gain=1.0 / 255.0)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("h,w,oh,ow", [(240, 320, 224, 224), (61, 83, 56, 40), (40, 80, 32, 32)])
def test_band_reproduces_the_dense_matrices(h, w, oh, ow):
    """The kernel's banded tables hold every nonzero of R_y and R_x, exactly, and
    together span exactly the input indices the matrix uses (the crop window)."""
    for m in pp.preprocess_matrices(h, w, oh, ow, 0.8):
        start, weights = pp.band(m)
        dense = np.zeros_like(m)
        for o in range(m.shape[0]):
            dense[o, start[o] : start[o] + weights.shape[1]] = weights[o]
        np.testing.assert_array_equal(dense, m)
        used = np.flatnonzero(m.any(axis=0))
        assert start.min() == used[0] and (start + weights.shape[1]).max() == used[-1] + 1


@pytest.mark.parametrize("shape,oh,ow", [((2, 3, 60, 80, 3), 56, 56), ((1, 2, 61, 83, 3), 56, 40),
                                         ((1, 1, 480, 856, 3), 224, 224)])
def test_reference_matches_jax_kernel_and_xla_path(shape, oh, ow):
    clips = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    ours = pp.fused_preprocess_reference(torch.from_numpy(clips), out_h=oh, out_w=ow,
                                         out_dtype=torch.float32).numpy()
    pallas = np.asarray(jax_fused_preprocess(jnp.asarray(clips), out_h=oh, out_w=ow,
                                             out_dtype=jnp.float32, interpret=True))
    xla = np.asarray(jax_center_crop_resize(jnp.asarray(clips), 0.8, oh, ow))
    assert ours.shape == shape[:2] + (oh, ow, 3)
    np.testing.assert_allclose(ours, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours, xla, atol=ATOL, rtol=0)


def test_center_crop_resize_matches_jax():
    """The port's plain crop+resize (F.interpolate, antialiased) vs JAX's."""
    clips = np.random.default_rng(1).integers(0, 256, (2, 3, 60, 80, 3), dtype=np.uint8)
    ours = center_crop_resize(torch.from_numpy(clips), 0.8, 56, 56).numpy()
    ref = np.asarray(jax_center_crop_resize(jnp.asarray(clips), 0.8, 56, 56))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    # ... and vs the matrix form, an independent formulation of the same resample.
    mat = pp.fused_preprocess_reference(torch.from_numpy(clips), out_h=56, out_w=56,
                                        out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(ours, mat, atol=ATOL, rtol=0)


def test_center_crop_resize_matches_the_plain_version_at_the_serving_shape():
    """K1's second library yardstick (F.interpolate, antialiased, on the crop) computes
    K1's function: within 5e-5 of the matrix form at 240x320 -> 224x224. PyTorch
    computes the filter weights in its own float arithmetic (measured 1.6e-5)."""
    clips = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (1, 2, 240, 320, 3),
                                                               dtype=np.uint8))
    ours = center_crop_resize(clips, 0.8, 224, 224)
    mat = pp.fused_preprocess_reference(clips, out_dtype=torch.float32)
    assert ours.shape == mat.shape
    np.testing.assert_allclose(ours.numpy(), mat.numpy(), atol=5e-5, rtol=0)


def test_kernel_tables_on_a_device_match_the_plan():
    """The word array the wrapper hands K1 (built for any device, here the CPU) holds
    the plan's tables at the offsets it passes."""
    plan = pp.k1_plan(240, 320, 224, 224, 0.8)
    words, (wrun, vw, xs, vstart) = pp._device_tables(plan.key, torch.device("cpu"))
    words = words.numpy()
    assert len(words) % 4 == 0 and wrun == 0 and min(vw, xs, vstart) % 4 == 0
    tiles = words[: plan.runs * (plan.span * 8 + 4)].reshape(plan.runs, -1)
    np.testing.assert_array_equal(tiles[:, :-4].reshape(plan.wrun.shape), plan.wrun)
    np.testing.assert_array_equal(words[vw : vw + plan.vw.size].reshape(plan.vw.shape), plan.vw)
    np.testing.assert_array_equal(words[xs : xs + plan.runs].view(np.int32), plan.xs)
    np.testing.assert_array_equal(words[vstart : vstart + 224].view(np.int32), plan.vstart)


def test_wrapper_on_cpu_takes_the_plain_path():
    clips = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 2, 48, 64, 3),
                                                               dtype=np.uint8))
    before = pp.fused_preprocess.launches
    for dtype in (torch.float32, torch.bfloat16):
        got = pp.fused_preprocess(clips, out_h=32, out_w=32, out_dtype=dtype)
        ref = pp.fused_preprocess_reference(clips, out_h=32, out_w=32, out_dtype=dtype)
        assert got.dtype == dtype and got.shape == (1, 2, 32, 32, 3)
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    assert pp.fused_preprocess.launches == before


@pytest.mark.parametrize("bad,kw", [
    (torch.zeros((1, 2, 8, 8, 3), dtype=torch.float32), {}),  # not uint8
    (torch.zeros((2, 8, 8, 3), dtype=torch.uint8), {}),  # not 5-D
    (torch.zeros((1, 2, 8, 8, 4), dtype=torch.uint8), {}),  # not RGB
    (torch.zeros((1, 2, 8, 8, 3), dtype=torch.uint8), {"out_dtype": torch.float16}),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, kw):
    with pytest.raises(ValueError):
        pp.fused_preprocess(bad, out_h=4, out_w=4, **kw)
