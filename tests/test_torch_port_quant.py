"""Port parity for the int8 W8A8 serving mode: ``ted_spad_tpu_torch.ops.{int8conv,
fast_unetpp, quant_unetpp, quant_i3d}`` and the extraction stage's int8 flow against
``ted_spad_tpu.ops.{quant_unetpp, quant_i3d}`` and ``stages.feature_extraction``, on the
same seeded numpy inputs and the same bridged weights, in float32 on the CPU.

Tolerances: weight codes and scales equal; the int8 -> int32 convolution equal, and
its dequantized output bit-equal; calibration absmax within 1e-5 relative; with the
same scales the int8 forwards within 1e-2 of max|out|, with the int8 codes of every
site equal in at least 99.9% of elements.

The JAX int8 forwards run op by op, not jitted: under jit XLA fuses the elementwise
epilogues (multiply-adds contracted), whose rounding puts a value on the other side of
a code's rounding boundary now and then (at 32^2, one code of enc_layer2_0_mid), and the
int8 chain carries such a flip on through every later site (8% of the codes differ by
x_0_2_out). Op by op the two packages round alike and the codes agree."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ted_spad_tpu.ops.quant_i3d as jqi
import ted_spad_tpu.ops.quant_unetpp as jqu
from ted_spad_tpu.models import load_fa_model as jax_load_fa
from ted_spad_tpu.models import load_ft_model as jax_load_ft
from ted_spad_tpu.ops.fast_i3d import space_to_depth_2x2
from ted_spad_tpu_torch.config.params import FeatureExtractionParams
from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
from ted_spad_tpu_torch.ops import fast_unetpp, int8conv, quant_i3d, quant_unetpp
from ted_spad_tpu_torch.ops.temporal import extraction_return_scramble
from ted_spad_tpu_torch.stages import feature_extraction as fe
from ted_spad_tpu_torch.utils.jax_weights import FT_HEADS, load_jax_variables

torch.set_num_threads(1)

CODES_AGREE = 0.999
OUT_RTOL = 1e-2
URIS = [f"synthetic://n=40,h=40,w=80,seed={s}" for s in (0, 1001, 2)]


def _perturbed(variables, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32) * rng.uniform(0.8, 1.2, np.shape(x))
                   + 0.05 * rng.standard_normal(np.shape(x))).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module")
def unetpp():
    """The full-width UNet++ at 32^2 in float32: (JAX model, variables, port module)."""
    model, variables = jax_load_fa(image_size=(32, 32), dtype="float32")
    variables = _perturbed(variables, 0)
    fa = load_jax_variables(load_fa_model(dtype="float32", device="cpu"), variables)
    return model, variables, fa


@pytest.fixture(scope="module")
def i3res50():
    """The tiny I3Res50 on 8x32^2 clips in float32: (JAX model, variables, port module)."""
    model, variables = jax_load_ft(clip_shape=(8, 32, 32), dtype="float32", tiny=True)
    variables = _perturbed(variables, 1)
    ft = load_jax_variables(load_ft_model(tiny=True, dtype="float32", device="cpu"), variables,
                            skip=FT_HEADS)
    return model, variables, ft


def _frames(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 3, 16, 8), (1, 1, 1, 32, 64), (5, 7, 7, 3, 16)])
def test_quantize_weight_matches_jax(shape):
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes the clamped scale
    codes, scale = int8conv.quantize_weight(torch.from_numpy(w))
    jcodes, jscale = jqu.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32


CONV_CASES = {
    "3x3 same": ((2, 9, 11, 16), (3, 3, 16, 8), (1, 1), ((1, 1), (1, 1)), None),
    "3x3 stride 2": ((2, 9, 11, 16), (3, 3, 16, 24), (2, 2), ((1, 1), (1, 1)), None),
    "1x1 stride 2": ((1, 8, 8, 32), (1, 1, 32, 16), (2, 2), ((0, 0), (0, 0)), None),
    "asymmetric pads": ((1, 7, 6, 8), (3, 3, 8, 8), (1, 1), ((0, 2), (1, 0)), None),
    "up2 4x4 dilated": ((2, 5, 6, 16), (4, 4, 16, 8), (1, 1), ((2, 2), (2, 2)), (2, 2)),
    "(3,1,1) temporal": ((2, 4, 5, 5, 16), (3, 1, 1, 16, 8), (1, 1, 1), ((1, 1), (0, 0), (0, 0)), None),
    "(1,3,3) stride 2": ((1, 2, 7, 7, 8), (1, 3, 3, 8, 16), (1, 2, 2), ((0, 0), (1, 1), (1, 1)), None),
    "stem Cin 3": ((1, 6, 12, 12, 3), (5, 7, 7, 3, 8), (2, 2, 2), ((2, 2), (3, 3), (3, 3)), None),
}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_int8_conv_matches_jax_exactly(name):
    xs, ws, strides, pads, dil = CONV_CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.integers(-127, 128, xs, dtype=np.int8)
    w = rng.standard_normal(ws).astype(np.float32)
    codes = np.array(jqu.quantize_weight(jnp.asarray(w))[0])
    dn = ("NDHWC", "DHWIO", "NDHWC") if len(xs) == 5 else ("NHWC", "HWIO", "NHWC")
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(codes), strides, pads,
                                        lhs_dilation=dil, dimension_numbers=dn,
                                        preferred_element_type=jnp.int32)
    got = int8conv.int8_conv_int32(torch.from_numpy(x), torch.from_numpy(codes), strides=strides,
                                   padding=pads, lhs_dilation=dil)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Through the dequant epilogue, against the JAX quantizer's conv: bit-equal.
    weight = int8conv.int8_weight(torch.from_numpy(w))
    for jdtype, dtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        qz = jqu._Quantizer("run", {"x": 0.037}, jdtype)
        want = qz.conv(jqu.QT(jnp.asarray(x), 0.037), jnp.asarray(w), strides=strides,
                       padding=pads, lhs_dilation=dil)
        got = int8conv.int8_conv(torch.from_numpy(x), weight, 0.037, strides=strides,
                                 padding=pads, lhs_dilation=dil, out_dtype=dtype)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_int8_conv_refuses_what_it_does_not_take():
    weight = int8conv.int8_weight(torch.ones(3, 3, 8, 4))
    with pytest.raises(ValueError, match="int8"):
        int8conv.int8_conv(torch.zeros(1, 5, 5, 8), weight, 0.1, padding=((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="channels"):
        int8conv.int8_conv(torch.zeros(1, 5, 5, 4, dtype=torch.int8), weight, 0.1,
                           padding=((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="2D kernel"):
        int8conv.int8_conv(torch.zeros(1, 2, 5, 5, 8, dtype=torch.int8), weight, 0.1,
                           padding=((1, 1), (1, 1)))


def test_packed_weight_layout():
    """K4's rows: K index tap * Cin32 + c, zero past Cin and up to a multiple of 64."""
    codes = torch.from_numpy(np.random.default_rng(5).integers(-127, 128, (3, 3, 3, 5),
                                                               dtype=np.int8))
    packed = int8conv.pack_weight(codes)
    assert packed.shape == (5, 320) and packed.dtype == torch.int8
    rows = packed[:, :288].reshape(5, 9, 32)
    np.testing.assert_array_equal(rows[:, :, :3].numpy(), codes.reshape(9, 3, 5).permute(2, 0, 1))
    assert not rows[:, :, 3:].any() and not packed[:, 288:].any()


def test_up2_conv_is_the_lhs_dilated_conv():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    w3 = rng.standard_normal((3, 3, 8, 4)).astype(np.float32)
    w44 = fast_unetpp.up2_dilated_kernel(torch.from_numpy(w3))
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w44.numpy()), (1, 1),
                                        [(2, 2), (2, 2)], lhs_dilation=(2, 2),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = fast_unetpp.up2_conv(torch.from_numpy(x), w44, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # And the nearest-up2 3x3 conv it replaces.
    up = torch.from_numpy(x).repeat_interleave(2, 1).repeat_interleave(2, 2)
    np.testing.assert_allclose(
        got.numpy(), fast_unetpp.conv_nhwc(up, torch.from_numpy(w3), (1, 1), ((1, 1), (1, 1)),
                                           torch.float32).numpy(), rtol=1e-5, atol=1e-5)


def test_calibration_sites_match_jax(unetpp, i3res50):
    jmodel, jvars, fa = unetpp
    frames = _frames((4, 32, 32, 3), 11)
    _, jstats = jax.jit(jqu.calibrate_unetpp, static_argnames="dtype")(
        jvars, jnp.asarray(frames), dtype=jnp.float32)
    out, stats = quant_unetpp.calibrate_unetpp(fa, torch.from_numpy(frames))
    assert set(stats) == set(jstats) and len(stats) == 26
    for k in jstats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5, err_msg=k)
    assert out.shape == (4, 32, 32, 3) and out.dtype == torch.float32

    fmodel, fvars, ft = i3res50
    clips = _frames((2, 8, 32, 32, 3), 12)
    _, jstats = jax.jit(lambda v, x: jqi.calibrate_i3d(fmodel, v, x))(fvars, jnp.asarray(clips))
    feat, stats = quant_i3d.calibrate_i3d(ft, torch.from_numpy(clips))
    assert set(stats) == set(jstats) and "i3d_stem_in" in stats and "i3d_in" in stats
    for k in jstats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5, err_msg=k)
    assert feat.shape == (2, 256)


class _RecordingQuantizer(jqu._Quantizer):
    """The JAX quantizer, keeping each site's int8 codes."""

    def q8(self, site, x):
        qt = super().q8(site, x)
        if self.mode == "run":
            self.stats[site] = qt.data
        return qt


class _PortRecordingQuantizer(quant_unetpp._Quantizer):
    """The port's quantizer, keeping each site's int8 codes in ``codes``: those ``q8``
    makes (the stem, the decoder's conv1 side) and those a conv's fused epilogue makes
    at its ``out_site``."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.codes = {}

    def q8(self, site, x):
        qt = super().q8(site, x)
        self.codes[site] = qt.data
        return qt

    def conv(self, qx, w, key, *, out_site=None, **kw):
        out = super().conv(qx, w, key, out_site=out_site, **kw)
        if out_site is not None:
            self.codes[out_site] = out.data
        return out


def _agree(port_codes: dict, jax_codes: dict, permute=None):
    assert set(port_codes) == set(jax_codes)
    for site, want in jax_codes.items():
        got = port_codes[site].numpy()
        if permute and site in permute:
            got = permute[site](got)
        assert got.shape == want.shape, site
        share = float((got == np.asarray(want)).mean())
        assert share >= CODES_AGREE, (site, share)


@pytest.mark.parametrize("up2_int8", [False, True])
def test_quant_fa_forward_matches_jax(unetpp, up2_int8):
    jmodel, jvars, fa = unetpp
    frames = _frames((4, 32, 32, 3), 13)
    _, jstats = jax.jit(jqu.calibrate_unetpp, static_argnames="dtype")(
        jvars, jnp.asarray(frames), dtype=jnp.float32)
    scales = jqu.act_scales_from_absmax(jstats)

    def run(v, x):
        qz = _RecordingQuantizer("run", scales, jnp.float32)
        return jqu._qforward(qz, v, x, False, up2_int8), qz.stats

    want, jcodes = run(jvars, jnp.asarray(frames))
    qz = _PortRecordingQuantizer("run", scales, torch.float32)
    got = quant_unetpp.fast_unetpp_apply_q(fa, torch.from_numpy(frames), scales,
                                           up2_int8=up2_int8, quantizer=qz)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_RTOL * np.abs(want).max(), rtol=0)
    _agree(qz.codes, jcodes)
    # The apply a step builds takes and returns the module's NCHW frames.
    apply = quant_unetpp.make_quant_fa_apply(fa, scales, up2_int8=up2_int8)
    nchw = apply(torch.from_numpy(frames).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), got.numpy())


@pytest.mark.parametrize("stem_int8", [False, True])
def test_quant_ft_forward_matches_jax(i3res50, stem_int8):
    fmodel, fvars, ft = i3res50
    clips = _frames((2, 8, 32, 32, 3), 14)
    _, jstats = jax.jit(lambda v, x: jqi.calibrate_i3d(fmodel, v, x))(fvars, jnp.asarray(clips))
    scales = jqu.act_scales_from_absmax(jstats)

    def run(v, x):
        qz = _RecordingQuantizer("run", scales, jnp.float32)
        return jqi._q_features(qz, v, x, fmodel.layer_specs, False, stem_int8), qz.stats

    want, jcodes = run(fvars, jnp.asarray(clips))
    qz = _PortRecordingQuantizer("run", scales, torch.float32)
    got = quant_i3d.fast_i3d_features_q(ft, torch.from_numpy(clips), scales, stem_int8=stem_int8,
                                        quantizer=qz)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_RTOL * np.abs(want).max(), rtol=0)
    # JAX quantizes the stem input on its 2x2 space-to-depth layout: the same codes permuted.
    _agree(qz.codes, jcodes, permute={"i3d_stem_in": lambda c: np.asarray(space_to_depth_2x2(c))})
    extract = quant_i3d.make_quant_ft_extract(ft, scales, stem_int8=stem_int8)
    np.testing.assert_array_equal(extract(torch.from_numpy(clips).permute(0, 4, 1, 2, 3)).numpy(),
                                  got.numpy())


def _int8_params(**kw):
    return FeatureExtractionParams(num_frames=8, batch_size=2, reso_h=32, reso_w=32,
                                   compute_dtype="float32", quant="int8", **kw)


def test_extraction_int8_flow(unetpp, i3res50, tmp_path):
    """extract_features(quant="int8") end to end on the CPU: the calibration batches are
    extracted too, every video gets its file, and the returned keys are the JAX stage's."""
    _, _, fa = unetpp
    _, _, ft = i3res50
    logs = []
    res = fe.extract_features(_int8_params(), URIS, str(tmp_path), fa=fa, ft=ft,
                              decode_hw=(40, 80), num_workers=2, device="cpu", log_fn=logs.append)
    assert set(res) == {"saved", "existing", "skipped", "clips", "elapsed_s", "clips_per_sec",
                        "quant_calib_batches_used", "quant_feature_cossim_vs_bf16"}
    assert res["clips"] == 6 and len(res["saved"]) == 3 and res["quant_calib_batches_used"] == 2
    assert 0.9 < res["quant_feature_cossim_vs_bf16"] <= 1.0
    assert any("feature cosine similarity vs bf16" in line for line in logs)
    no_check = fe.extract_features(_int8_params(quant_fidelity_check=False, quant_calib_batches=1),
                                   URIS, str(tmp_path / "b"), fa=fa, ft=ft, decode_hw=(40, 80),
                                   num_workers=2, device="cpu", log_fn=lambda s: None)
    assert no_check["quant_calib_batches_used"] == 1
    assert "quant_feature_cossim_vs_bf16" not in no_check


def test_int8_step_quantizes_ft_only_with_its_sites(unetpp, i3res50):
    """Scales without the ft's sites leave the ft in the compute dtype; with them the
    int8 ft runs (the features move)."""
    _, _, fa = unetpp
    _, _, ft = i3res50
    p = _int8_params()
    clips = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 8, 40, 80, 3),
                                                               dtype=np.uint8))
    stats = fe.make_fa_calibration_step(p, fa, ft, device="cpu")(clips)
    scales = quant_unetpp.act_scales_from_absmax(stats)
    fa_only = {k: v for k, v in scales.items() if not k.startswith("i3d_")}
    bf = fe.make_extract_step(ft, p.replace(quant="none"), fa, device="cpu")(clips)
    q_fa = fe.make_extract_step(ft, p, fa, device="cpu", quant_act_scales=fa_only)(clips)
    q_both = fe.make_extract_step(ft, p, fa, device="cpu", quant_act_scales=scales)(clips)
    assert bf.shape == q_fa.shape == q_both.shape == (2, 256)
    assert not torch.equal(q_fa, q_both) and not torch.equal(bf, q_fa)


def test_quant_ft_falls_back_for_another_ft(unetpp, tmp_path):
    _, _, fa = unetpp
    ft = load_ft_model("r3d_18", dtype="float32", device="cpu")
    logs = []
    res = fe.extract_features(_int8_params(), URIS[:1], str(tmp_path), fa=fa, ft=ft,
                              decode_hw=(40, 80), num_workers=1, device="cpu", log_fn=logs.append)
    assert "quant int8: ft is not a standard WrapperI3D — quantizing fa only" in logs
    assert res["clips"] == 2 and np.load(next(iter(res["saved"].values()))).shape == (2, 512)


@pytest.mark.parametrize("arch", ["unet", "tiny unet++"])
def test_int8_refuses_a_nonstandard_fa_before_decoding(arch, tmp_path, monkeypatch):
    """Deviation from the JAX stage (ADVICE.md finding 1): the fa is checked before any
    decode or calibration, so a non-standard one raises ValueError up front (the JAX
    stage calibrates first and fails inside the calibration pass)."""
    def no_decode(*a, **k):
        raise AssertionError("decoded before validating the configuration")

    monkeypatch.setattr(fe, "open_video", no_decode)
    fa = load_fa_model("unet++", tiny=True, dtype="float32", device="cpu") if arch != "unet" \
        else None
    p = _int8_params(arch_fa="unet") if arch == "unet" else _int8_params()
    ft = load_ft_model(tiny=True, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="standard UNet\\+\\+"):
        fe.extract_features(p, URIS, str(tmp_path), fa=fa, ft=ft, decode_hw=(40, 80),
                            device="cpu", log_fn=lambda s: None)
    with pytest.raises(ValueError, match="anonymized"):
        fe.extract_features(_int8_params(anonymized=False), URIS, str(tmp_path), ft=ft,
                            decode_hw=(40, 80), device="cpu", log_fn=lambda s: None)


def test_int8_calibrates_ft_on_the_scrambled_tensor_under_quirk_compat(unetpp, i3res50):
    """Deviation from the JAX stage (ADVICE.md finding 2): under quirk_compat the int8
    step feeds ft the scrambled fa output, so ft is calibrated on exactly that tensor
    (the JAX stage calibrates ft on the unscrambled clips)."""
    _, _, fa = unetpp
    _, _, ft = i3res50
    p = _int8_params(quirk_compat=True)
    clips = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 8, 40, 80, 3),
                                                               dtype=np.uint8))
    stats = fe.make_fa_calibration_step(p, fa, ft, device="cpu")(clips)
    img = fe._make_preprocess(p, False, False, (40, 80))(clips)
    anon, fa_stats = quant_unetpp.calibrate_unetpp(fa, img.reshape(16, 32, 32, 3))
    _, scrambled = quant_i3d.calibrate_i3d(ft, extraction_return_scramble(anon, 2, 8))
    _, clean = quant_i3d.calibrate_i3d(ft, anon.reshape(2, 8, 32, 32, 3))
    assert set(stats) == set(fa_stats) | set(scrambled)
    for k, v in scrambled.items():
        assert float(stats[k]) == float(v), k
    assert any(float(clean[k]) != float(scrambled[k]) for k in clean if k != "i3d_stem_in")


def test_cli_modes_never_share_a_feature_cache_entry(tmp_path):
    """score_video's feature cache is keyed on the decode mode and the quant settings:
    bf16 rgb, int8 and yuv runs into one out_dir land in three entries."""
    from ted_spad_tpu_torch import score_video

    for extra in ([], ["--quant", "int8", "--quant_calib_batches", "1"], ["--decode_mode", "yuv"]):
        args = score_video.parser().parse_args(["--synthetic", "--device", "cpu", "--out_dir",
                                                str(tmp_path), "--num_workers", "2", *extra])
        summaries = score_video.run(args)
        assert len(summaries) == 2 and all("error" not in s for s in summaries)
    entries = [d for d in (tmp_path / "features").iterdir() if d.is_dir()]
    assert len(entries) == 3
    configs = [(d / "_extract_config.txt").read_text() for d in entries]
    assert sum("quant='int8'" in c for c in configs) == 1
    assert sum("|yuv|" in c for c in configs) == 1
