"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card (the kernels are CUDA C++ with no CPU mode) and skip
without one. They import neither JAX nor the JAX package, so a CUDA host without
JAX runs them with:

    python -m pytest tests/test_torch_port_kernels.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from ted_spad_tpu_torch.chip_probes import K4_FORMS, k4_epilogue
from ted_spad_tpu_torch.ops import doubleconv as dc
from ted_spad_tpu_torch.ops import int8conv
from ted_spad_tpu_torch.ops import preprocess as pp
from ted_spad_tpu_torch.ops import yuv
from ted_spad_tpu_torch.utils.device import tf32_off


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,oh,ow,offset", [
    ((16, 16, 240, 320, 3), 224, 224, 0),   # the serving batch
    ((2, 3, 61, 83, 3), 56, 40, 0),         # ragged
    ((1, 4, 480, 856, 3), 224, 224, 0),     # unaligned row pitch and window, KY 4, KX 7
    ((1, 2, 1080, 1920, 3), 224, 224, 0),   # KY 8, KX 14
    ((16, 16, 240, 320, 3), 224, 224, 1),   # unaligned base address
    ((1, 2, 200, 300, 3), 16, 16, 0),       # past every compile-time instantiation
])
def test_preprocess_kernel_matches_plain_version(cuda_device, shape, oh, ow, offset):
    """K1 vs its plain version: float32 out within 1e-5; bf16 out within one bf16 ulp
    at 1.0 (2**-7) of the plain version cast to bf16. The plain version runs its
    matmuls in full float32 (TF32 off)."""
    data = torch.from_numpy(np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8))
    clips = torch.empty(data.numel() + offset, dtype=torch.uint8, device=cuda_device)[offset:]
    clips = clips.view(shape).copy_(data)
    launches = pp.fused_preprocess.launches
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        got = pp.fused_preprocess(clips, out_h=oh, out_w=ow, out_dtype=dtype)
        with tf32_off():
            ref = pp.fused_preprocess_reference(clips, out_h=oh, out_w=ow, out_dtype=dtype)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.dtype == dtype
        assert float((got.float() - ref.float()).abs().max()) <= tol
    assert pp.fused_preprocess.launches == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,oh,ow,ncrops", [
    ((2, 16, 240, 320, 3), 224, 224, 10),   # the serving frame's ten crops
    ((1, 4, 480, 856, 3), 224, 224, 10),    # ShanghaiTech's frame
    ((2, 3, 61, 83, 3), 56, 44, 10),        # ragged: a mirrored short last run
    ((2, 3, 240, 320, 3), 224, 224, 1),     # no_ar_distortion's square window
])
def test_preprocess_kernel_over_crops_matches_plain_version(cuda_device, shape, oh, ow, ncrops):
    """K1 over crops in one launch (windows shifted from the first, five mirrored) vs
    the plain version with the same crops, at K1's tolerances."""
    h, w = shape[2:4]
    crops = (pp.multi_crops(h, w, 0.8, ncrops) if ncrops > 1
             else [pp.center_crop(h, w, 0.8, square=True)])
    data = torch.from_numpy(np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8))
    clips = data.to(cuda_device)
    launches = pp.fused_preprocess.launches
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        got = pp.fused_preprocess(clips, out_h=oh, out_w=ow, crops=crops, out_dtype=dtype)
        with tf32_off():
            ref = pp.fused_preprocess_reference(clips, out_h=oh, out_w=ow, crops=crops,
                                                out_dtype=dtype)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (shape[0], len(crops)) + shape[1:2] + (oh, ow, 3)
        assert float((got.float() - ref.float()).abs().max()) <= tol
    assert pp.fused_preprocess.launches == launches + 2


@pytest.mark.cuda
def test_preprocess_kernel_rejects_non_contiguous(cuda_device):
    clips = torch.zeros((2, 2, 16, 16, 3), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        pp.fused_preprocess(clips[:, :, ::2], out_h=8, out_w=8)


def _double_conv_operands(device, shape, dtype, b1=None):
    n, h, w, cin, cmid, cout = shape
    g = torch.Generator().manual_seed(4)
    x = torch.randn(n, h, w, cin, generator=g)
    w1 = torch.randn(3, 3, cin, cmid, generator=g) * (2 / (9 * cin)) ** 0.5
    w2 = torch.randn(3, 3, cmid, cout, generator=g) * (2 / (9 * cmid)) ** 0.5
    b1 = torch.randn(cmid, generator=g) * 0.1 if b1 is None else torch.full((cmid,), b1)
    b2 = torch.randn(cout, generator=g) * 0.1
    return [t.to(device) for t in (x.to(dtype), w1.to(dtype), b1, w2.to(dtype), b2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,b1", [
    ((2, 224, 224, 3, 64, 64), None),    # inc: Cin = 3, K padded inside the kernel
    ((2, 28, 28, 1024, 512, 256), None),  # up1: the widest
    ((2, 13, 17, 24, 16, 8), None),       # ragged frame and channel counts
    ((1, 28, 28, 16, 8, 8), 5.0),         # halo: conv2 must see zeros outside the image
    ((2, 20, 20, 64, 64, 64), None),      # bf16 16x16 class, ragged
    ((2, 20, 30, 96, 128, 64), None),     # bf16 16x28 class, ragged
    ((2, 20, 30, 128, 256, 128), None),   # bf16 14x14 class, ragged
    ((2, 12, 20, 256, 512, 256), None),   # bf16 7x14 class, ragged
])
def test_double_conv_kernel_matches_plain_version(cuda_device, shape, b1):
    """K2 vs its plain version (float32 convs with TF32 off): f32 within 1e-4 of
    max|ref| (summation order); bf16 within 2**-6 of max|ref|, one to two bf16 ulps at
    the largest value (summation order, and with it an occasional flip in the rounding
    of a conv1 value or of the output)."""
    launches = dc.fused_double_conv.launches
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)):
        args = _double_conv_operands(cuda_device, shape, dtype, b1)
        got = dc.fused_double_conv(*args)
        with tf32_off():
            ref = dc.double_conv_reference(*args)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.dtype == dtype
        scale = float(ref.float().abs().max())
        assert scale > 0 and float((got.float() - ref.float()).abs().max()) <= tol * scale
    assert dc.fused_double_conv.launches == launches + 2


@pytest.mark.cuda
def test_double_conv_kernel_rejects_what_it_does_not_take(cuda_device):
    x, w1, b1, w2, b2 = _double_conv_operands(cuda_device, (1, 8, 8, 16, 16, 16), torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        dc.fused_double_conv(x[:, :, ::2], w1, b1, w2, b2)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        dc.fused_double_conv(shifted, w1, b1, w2, b2)


@pytest.mark.cuda
def test_double_conv_kernel_refuses_to_cut_a_gradient(cuda_device):
    """K2 has no backward: under grad mode with an input that requires grad it raises
    and launches nothing; under no_grad the same call runs."""
    x, w1, b1, w2, b2 = _double_conv_operands(cuda_device, (1, 8, 8, 16, 16, 16), torch.bfloat16)
    before = dc.fused_double_conv.launches
    with pytest.raises(RuntimeError, match="no backward"):
        dc.fused_double_conv(x, w1.requires_grad_(True), b1, w2, b2)
    assert dc.fused_double_conv.launches == before
    with torch.no_grad():
        out = dc.fused_double_conv(x, w1, b1, w2, b2)
    assert out.grad_fn is None and dc.fused_double_conv.launches == before + 1


@pytest.mark.cuda
def test_double_conv_kernel_refuses_a_cmid_no_tile_fits(cuda_device):
    x, w1, b1, w2, b2 = _double_conv_operands(cuda_device, (1, 8, 8, 16, 1024, 16), torch.bfloat16)
    launches = dc.fused_double_conv.launches
    with pytest.raises(ValueError, match="Cmid"):
        dc.fused_double_conv(x, w1, b1, w2, b2)
    assert dc.fused_double_conv.launches == launches


def _yuv_rows(device, b, t, h, w, tagged, offset=0, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (b, t, yuv.packed_row_bytes(h, w) + int(tagged)), dtype=np.uint8)
    if tagged:
        data[:, :, -1] = (np.arange(b) % 4)[:, None]
    buf = torch.empty(data.size + offset, dtype=torch.uint8, device=device)
    rows = buf[offset:].view(data.shape)
    rows.copy_(torch.from_numpy(data))
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tagged,offset", [
    ((16, 16, 240, 320), True, 0),   # the serving batch, four colour sets
    ((2, 16, 240, 320), False, 0),   # rows without the tag byte
    ((2, 8, 480, 856), True, 0),     # runtime taps
    ((2, 4, 240, 320), True, 1),     # every row unaligned
    ((2, 3, 40, 80), True, 0),
    ((2, 4, 480, 856), True, 3),     # <4, 32, 2, 16>, unaligned
    ((2, 4, 480, 856), False, 1),
    ((4, 2, 360, 640), True, 1),     # <4, 32, 2, 16> at 360x640
    ((4, 1, 720, 1280), True, 5),    # 720p
    ((1, 2, 1080, 1920), False, 7),  # 1080p, untagged
    ((1, 2, 1080, 1920), True, 1),
    ((1, 2, 2240, 2240), True, 1),   # past every compile-time instantiation
])
def test_yuv_preprocess_kernel_matches_plain_version(cuda_device, shape, tagged, offset):
    b, t, h, w = shape
    rows = _yuv_rows(cuda_device, b, t, h, w, tagged, offset, seed=h)
    launches = yuv.fused_preprocess_yuv.launches
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        got = yuv.fused_preprocess_yuv(rows, (h, w), out_dtype=dtype)
        y, u, v, bt709, full = yuv.unpack_yuv(rows, (h, w))
        with tf32_off():
            ref = yuv.fused_preprocess_yuv_reference(y, u, v, out_dtype=dtype, bt709=bt709, full=full)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.dtype == dtype
        scale = float(ref.float().abs().max())
        assert float((got.float() - ref.float()).abs().max()) <= tol * scale
    assert yuv.fused_preprocess_yuv.launches == launches + 2


@pytest.mark.cuda
def test_yuv_preprocess_kernel_refuses_a_misaligned_window(cuda_device):
    rows = _yuv_rows(cuda_device, 1, 2, 50, 70, True)
    with pytest.raises(ValueError, match="chroma-misaligned"):
        yuv.fused_preprocess_yuv(rows, (50, 70))


@pytest.mark.cuda
@pytest.mark.parametrize("xs,ws,strides,pads,dil", [
    ((2, 56, 56, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1)), None),
    ((1, 8, 32, 32, 3), (5, 7, 7, 3, 64), (2, 2, 2), ((2, 2), (3, 3), (3, 3)), None),
    ((2, 13, 17, 48), (3, 3, 48, 40), (1, 1), ((1, 1), (1, 1)), None),
    ((2, 57, 55, 64), (3, 3, 64, 128), (2, 2), ((1, 1), (1, 1)), None),
    ((2, 8, 14, 14, 256), (3, 1, 1, 256, 64), (1, 1, 1), ((1, 1), (0, 0), (0, 0)), None),
    ((2, 28, 28, 64), (4, 4, 64, 32), (1, 1), ((2, 2), (2, 2)), (2, 2)),
    ((1, 9, 10, 32), (3, 3, 32, 24), (1, 1), ((0, 2), (1, 0)), None),
])
def test_int8_conv_kernel_is_bit_equal_to_plain_version(cuda_device, xs, ws, strides, pads, dil):
    rng = np.random.default_rng(sum(xs))
    x = torch.from_numpy(rng.integers(-127, 128, xs, dtype=np.int8)).to(cuda_device)
    weight = int8conv.int8_weight(torch.from_numpy(rng.standard_normal(ws).astype(np.float32))
                                  .to(cuda_device))
    launches = int8conv.int8_conv.launches
    for dtype in (torch.bfloat16, torch.float32):
        kw = dict(strides=strides, padding=pads, lhs_dilation=dil, out_dtype=dtype)
        got = int8conv.int8_conv(x, weight, 0.05, **kw)
        ref = int8conv.int8_conv(x, weight, 0.05, use_kernel=False, **kw)
        assert got.shape == ref.shape and torch.equal(got, ref)
    assert int8conv.int8_conv.launches == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(K4_FORMS))
@pytest.mark.parametrize("xs,ws,strides,pads", [
    ((2, 28, 28, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1))),
    ((2, 13, 17, 48), (3, 3, 48, 5), (1, 1), ((1, 1), (1, 1))),
    ((2, 4, 15, 15, 128), (1, 3, 3, 128, 72), (1, 2, 2), ((0, 0), (1, 1), (1, 1))),
    ((2, 3, 13, 19, 64), (1, 3, 3, 64, 72), (1, 1, 1), ((0, 0), (1, 1), (1, 1))),
])
def test_int8_conv_kernel_epilogue_is_bit_equal_to_plain_version(cuda_device, form, xs, ws,
                                                                  strides, pads):
    """Each fused epilogue form of the int8 path, bf16 and float32: K4 equals the plain
    version (int32 sums, then the epilogue's torch ops) bit for bit."""
    rng = np.random.default_rng(sum(xs) + len(form))
    x = torch.from_numpy(rng.integers(-127, 128, xs, dtype=np.int8)).to(cuda_device)
    weight = int8conv.int8_weight(torch.from_numpy(rng.standard_normal(ws).astype(np.float32))
                                  .to(cuda_device))
    kw = dict(strides=strides, padding=pads)
    out_shape = int8conv.conv_out_shape(xs, ws, **kw)
    for dtype in (torch.bfloat16, torch.float32):
        ep = k4_epilogue(form, weight, out_shape, dtype, cuda_device, seed=len(xs))
        got = int8conv.int8_conv(x, weight, 0.05, out_dtype=dtype, epilogue=ep, **kw)
        ref = int8conv.int8_conv(x, weight, 0.05, out_dtype=dtype, epilogue=ep, use_kernel=False,
                                 **kw)
        assert got.dtype == ref.dtype and got.shape == ref.shape and torch.equal(got, ref)


@pytest.mark.cuda
def test_int8_conv_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((1, 8, 8, 32), dtype=torch.int8, device=cuda_device)
    weight = int8conv.int8_weight(torch.ones((3, 3, 32, 8), device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        int8conv.int8_conv(x[:, :, ::2], weight, 0.1, padding=((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="float64"):
        int8conv.int8_conv(x, weight, 0.1, padding=((1, 1), (1, 1)), out_dtype=torch.float64)
