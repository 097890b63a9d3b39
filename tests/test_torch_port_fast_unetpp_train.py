"""Port parity of the UNet++ train fast form (ted_spad_tpu_torch/ops/fast_unetpp.py:
``fast_encoder_train_apply``, ``fast_unetpp_train_apply``, the remat pieces,
``make_fast_fa_apply(train=True)``'s routing, ``_conv_wpack``) against the JAX package's
ops/fast_unetpp.py, JAX's module train apply and the port's module train forward.

The full-width UNet++ (the fast form needs the (256, 128, 64, 32) decoder) at 2 frames of
32^2 on the CPU, weights from the port's seeded init written out and perturbed leaf by
leaf (``test_torch_port_fullwidth.bridged``), then given to both packages. Each function
is held on its output, every BN running statistic and every parameter's gradient of a
loss that weighs each output element by a seeded probe:

- float64 against JAX's module train apply and the port's module, to 1e-8 of each
  tensor's norm (the same function: the fast form only re-associates sums);
- float64 against JAX's fast function to 5e-5: that function takes its BN statistics
  in float32 even in float64 (its ``_convbn_train`` casts to float32), which puts it
  1.0e-5 from JAX's own module in this test's step;
- float32 against JAX's fast function: outputs and statistics at rtol / atol 2e-4,
  gradients under the JAX package's robust metric (tests/test_fast_unetpp.py: L2
  relative error < 2e-2, a share < 2e-3 of elements off by more than 5e-2 of the
  largest), since ReLU masks flip for pre-activations within rounding of 0."""

from __future__ import annotations

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_fullwidth import bridged
from ted_spad_tpu.models.resnet2d import ResNet2D as JaxResNet2D
from ted_spad_tpu.models.unet import UNetPlusPlus as JaxUNetPlusPlus
from ted_spad_tpu.ops import fast_unetpp as jax_fast
from ted_spad_tpu_torch.config.params import AnonymizationParams
from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model
from ted_spad_tpu_torch.models.unet import UNetPlusPlus
from ted_spad_tpu_torch.ops import fast_unetpp
from ted_spad_tpu_torch.stages import anonymization_training as anon
from ted_spad_tpu_torch.stages import fa_pretraining
from ted_spad_tpu_torch.stages.common import make_optimizer
from ted_spad_tpu_torch.utils.jax_weights import _KERNEL_PERM, _LEAF_NAMES, load_jax_variables

torch.set_num_threads(1)

F64_RTOL = 1e-8  # against the same function in real arithmetic
JAX_FAST_F64_RTOL = 5e-5  # JAX's fast form keeps float32 BN statistics
F32_TOL = 2e-4  # outputs and statistics in float32 (the JAX package's limit)
# A gradient that is zero in exact arithmetic (a bias that a train-mode BN after it
# removes) is rounding noise on both sides: held absolutely, below this share of the
# step's largest gradient (tests/test_torch_port_train_stages.py's NULL_GRAD).
NULL_GRAD = 1e-5
SIDE = 32


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def robust_ok(got, ref) -> tuple[bool, float, float]:
    """The JAX package's float32 gradient metric: (ok, L2 relative error, outlier share)."""
    a, b = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    scale = max(float(np.abs(a).max()), 1e-6)
    l2rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-9)
    frac_bad = float(np.mean(np.abs(b - a) / scale > 5e-2))
    return l2rel < 2e-2 and frac_bad < 2e-3, l2rel, frac_bad


def torch_layout(tree, prefix: str = "") -> dict:
    """A flax tree's leaves under the port's state_dict keys and layouts, float64."""
    out = {}

    def walk(node, path):
        for k, a in node.items():
            if isinstance(a, dict):
                walk(a, path + (k,))
                continue
            a = np.asarray(a, np.float64)
            if k == "kernel":
                a = a.transpose(_KERNEL_PERM[a.ndim])
            out[prefix + ".".join(path + (_LEAF_NAMES.get(k, k),))] = a

    walk(tree, ())
    return out


@pytest.fixture(scope="module")
def unetpp():
    """(the perturbed weights as a float32 flax tree, the port's UNet++ holding them)."""
    fa = load_fa_model(dtype="float32", device="cpu")
    variables = bridged(fa, JaxUNetPlusPlus(dtype=jnp.float32), jnp.zeros((1, SIDE, SIDE, 3)), seed=5)
    return variables, load_jax_variables(fa, variables)


def frames(n: int, seed: int, dtype=np.float64) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (n, SIDE, SIDE, 3)).astype(dtype)


def probes(shapes, seed: int, dtype=np.float64) -> list:
    """Seeded weights of each output element, float32 values (exact in either dtype: an
    output JAX casts to float32 gets them as its cotangent unrounded)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32).astype(dtype) for s in shapes]


def jax_step(fn, params, x, weights) -> tuple[list, dict, dict]:
    """``fn(params, x) -> (outputs, batch_stats tree)`` through one jitted value and
    grad of sum(probe * output): (outputs, gradients, statistics) as numpy, the last two
    in the port's layout."""
    def loss(q):
        outs, stats = fn(q, x)
        return sum((o * w).sum() for o, w in zip(outs, weights)), (outs, stats)

    (_, (outs, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return [np.asarray(o) for o in outs], torch_layout(to_np(grads)), torch_layout(to_np(stats))


def port_step(fn, model, x, weights) -> tuple[list, dict, dict]:
    """The same for the port: ``fn(model, x) -> outputs``, backward, then each
    parameter's gradient and each running statistic of ``model``."""
    outs = fn(model.requires_grad_(True), torch.from_numpy(x))
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights)).backward()
    grads = {n: q.grad.double().numpy() for n, q in model.named_parameters()}
    stats = {n: t.double().numpy() for n, t in model.named_buffers() if "running" in n}
    return [o.detach().double().numpy() for o in outs], grads, stats


def assert_step(got, ref, rtol: float) -> None:
    """Outputs, gradients and statistics each within ``rtol`` of the reference's norm;
    an output the reference gives in float32 (the heads' casts) within its rounding."""
    (outs, grads, stats), (r_outs, r_grads, r_stats) = got, ref
    assert len(outs) == len(r_outs)
    for o, r in zip(outs, r_outs):
        assert o.shape == r.shape and np.isfinite(o).all()
        tol = max(rtol, 2.0 ** -23) if r.dtype == np.float32 else rtol
        assert rel(o, r) <= tol, rel(o, r)
    for k in live_grads(grads, r_grads):
        assert rel(grads[k], r_grads[k]) <= rtol, (k, rel(grads[k], r_grads[k]))
    assert stats.keys() == r_stats.keys()
    for k in r_stats:
        assert rel(stats[k], r_stats[k]) <= rtol, (k, rel(stats[k], r_stats[k]))


def live_grads(grads: dict, ref: dict) -> list:
    """The gradients to compare: the same keys on both sides; those the reference gives
    as zero in exact arithmetic (``NULL_GRAD``) are checked here, absolutely, and left
    out."""
    assert grads.keys() == ref.keys()
    top = max(np.linalg.norm(g) for g in ref.values())
    null = [k for k, g in ref.items() if np.linalg.norm(g) <= NULL_GRAD * top]
    for k in null:
        assert np.linalg.norm(grads[k]) <= NULL_GRAD * top, k
    return [k for k in ref if k not in null]


def assert_step_f32(got, ref) -> None:
    """Float32: outputs and statistics at F32_TOL, gradients under ``robust_ok``."""
    (outs, grads, stats), (r_outs, r_grads, r_stats) = got, ref
    for o, r in zip(outs, r_outs):
        np.testing.assert_allclose(o, r, rtol=F32_TOL, atol=F32_TOL)
    for k in live_grads(grads, r_grads):
        ok, l2rel, frac = robust_ok(grads[k], r_grads[k])
        assert ok, (k, l2rel, frac)
    assert stats.keys() == r_stats.keys()
    for k in r_stats:
        np.testing.assert_allclose(stats[k], r_stats[k], rtol=F32_TOL, atol=F32_TOL, err_msg=k)


def cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dtype)), tree)


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------

ENC_SHAPES = [(2, 16, 16, 64), (2, 8, 8, 64), (2, 4, 4, 128), (2, 2, 2, 256)]


@pytest.mark.parametrize("stem_mode", ["plain", "s2d"])
def test_fast_encoder_train_matches_jax(unetpp, stem_mode):
    """fast_encoder_train_apply: the four features, every running statistic of the
    encoder (moved once) and every encoder gradient, the stem's (64, 3, 7, 7) weight's
    through the stem mode's kernel transform included."""
    variables, fa = unetpp
    x = frames(2, 1)
    weights = probes(ENC_SHAPES, 2)

    def port_fn(enc, t):
        return fast_unetpp.fast_encoder_train_apply(enc, t, t.dtype, stem_mode)

    got = port_step(port_fn, copy.deepcopy(fa.encoder).double(), x, weights)
    got32 = port_step(port_fn, copy.deepcopy(fa.encoder), x.astype(np.float32),
                      [w.astype(np.float32) for w in weights])

    def fast(dtype):
        def fn(p, t):
            return jax_fast.fast_encoder_train_apply(p, enc_vars["batch_stats"], t, dtype,
                                                     stem_mode)
        return fn

    jenc = JaxResNet2D(block="basic", layers=(2, 2, 2, 2), depth=4, dtype=jnp.float64)

    def module(p, t):
        feats, mut = jenc.apply({"params": p, "batch_stats": enc_vars["batch_stats"]}, t,
                                train=True, mutable=["batch_stats"])
        return feats[1:], mut["batch_stats"]

    with jax.enable_x64(True):
        enc_vars = cast({k: variables[k]["encoder"] for k in variables}, np.float64)
        ref_module = jax_step(module, enc_vars["params"], jnp.asarray(x), weights)
        ref_fast = jax_step(fast(jnp.float64), enc_vars["params"], jnp.asarray(x), weights)
    enc_vars = cast({k: variables[k]["encoder"] for k in variables}, np.float32)
    ref32 = jax_step(fast(jnp.float32), enc_vars["params"], jnp.asarray(x, jnp.float32),
                     [w.astype(np.float32) for w in weights])
    assert "stem.conv.weight" in got[1] and np.abs(got[1]["stem.conv.weight"]).max() > 0
    assert_step(got, ref_module, F64_RTOL)
    assert_step(got, ref_fast, JAX_FAST_F64_RTOL)
    assert_step_f32(got32, ref32)


# ---------------------------------------------------------------------------
# The whole forward
# ---------------------------------------------------------------------------


def test_fast_unetpp_train_apply_matches_jax(unetpp):
    """fast_unetpp_train_apply on the standard UNet++: its float32 output, every running
    statistic (encoder and decoder, moved once) and every parameter's gradient, against
    JAX's module train apply and JAX's fast_unetpp_train_apply in float64, and JAX's
    fast function in float32."""
    variables, fa = unetpp
    x = frames(2, 3)
    weights = probes([(2, SIDE, SIDE, 3)], 4)

    def port_fn(model, t):
        out = fast_unetpp.fast_unetpp_train_apply(model, t)
        assert out.dtype == torch.float32  # as the module's and JAX's heads give
        return [out]

    got = port_step(port_fn, copy.deepcopy(fa).double(), x, weights)
    got32 = port_step(port_fn, copy.deepcopy(fa), x.astype(np.float32),
                      [w.astype(np.float32) for w in weights])

    def fast(dtype):
        def fn(p, t):
            out, mut = jax_fast.fast_unetpp_train_apply({**v, "params": p}, t, dtype=dtype)
            return [out], mut["batch_stats"]
        return fn

    with jax.enable_x64(True):
        v = cast(variables, np.float64)
        jmodel = JaxUNetPlusPlus(dtype=jnp.float64)

        def module(p, t):
            out, mut = jmodel.apply({**v, "params": p}, t, train=True, mutable=["batch_stats"])
            return [out], mut["batch_stats"]

        ref_module = jax_step(module, v["params"], jnp.asarray(x), weights)
        ref_fast = jax_step(fast(jnp.float64), v["params"], jnp.asarray(x), weights)
    v = cast(variables, np.float32)
    ref32 = jax_step(fast(jnp.float32), v["params"], jnp.asarray(x, jnp.float32),
                     [w.astype(np.float32) for w in weights])
    assert len(got[1]) == sum(1 for _ in fa.parameters())
    assert_step(got, ref_module, F64_RTOL)
    assert_step(got, ref_fast, JAX_FAST_F64_RTOL)
    assert_step_f32(got32, ref32)


def _module_step(model, t):
    return [model(t.permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)]


def _routed_step(model, t, **kw):
    return [fast_unetpp.make_fast_fa_apply(model)(t.permute(0, 3, 1, 2), train=True,
                                                  **kw).permute(0, 2, 3, 1)]


@pytest.mark.parametrize("encoder", ["inline", "module"])
def test_train_form_is_the_module_step(unetpp, encoder, monkeypatch):
    """make_fast_fa_apply(train=True) in float64 against the port's module train forward
    on the same weights: output, statistics and gradients to 1e-8; over the standard
    encoder (inline) and over a non-standard one, which runs the module encoder in train
    mode inside the fused decoder (the JAX package's encoder_module branch), the train
    form running either way."""
    _, base = unetpp
    if encoder == "inline":
        fa = copy.deepcopy(base).double()
    else:
        fa = UNetPlusPlus(encoder_layers=(1, 1, 1, 1), generator=torch.Generator().manual_seed(3))
        assert not fast_unetpp.encoder_layout_standard(fa.encoder)
        fa = fa.double()  # its seeded init
    calls = []
    real = fast_unetpp.fast_unetpp_train_apply
    monkeypatch.setattr(fast_unetpp, "fast_unetpp_train_apply",
                        lambda *a, **k: calls.append(k["encoder_apply"] is None) or real(*a, **k))
    x = frames(3, 5)
    weights = probes([(3, SIDE, SIDE, 3)], 6)
    ref = port_step(_module_step, copy.deepcopy(fa), x, weights)
    got = port_step(_routed_step, fa, x, weights)
    assert calls == [encoder == "inline"]
    assert_step(got, ref, F64_RTOL)


def test_remat_blocks_gives_the_same_step(unetpp, monkeypatch):
    """remat_blocks checkpoints the eleven pieces of TRAIN_REMAT_SAVE_NAMES one by one
    (eleven checkpoints with it, none without):
    the same output and gradients as without it, the running statistics moved once (a
    second move in the recompute would change them by a tenth of the batch statistic);
    the backward runs without an autograd anomaly (an in-place op on a tensor autograd
    saved) with checkpointing on and off."""
    _, base = unetpp
    x = frames(2, 7, np.float32)
    weights = probes([(2, SIDE, SIDE, 3)], 8, np.float32)
    pieces = []
    real = fast_unetpp.checkpoint
    monkeypatch.setattr(fast_unetpp, "checkpoint",
                        lambda fn, *a, **k: pieces.append(1) or real(fn, *a, **k))
    runs = []
    for blocks in (False, True):
        pieces.clear()
        with torch.autograd.set_detect_anomaly(True):
            runs.append(port_step(functools.partial(_routed_step, remat_blocks=blocks),
                                  copy.deepcopy(base), x, weights))
        assert len(pieces) == (len(fast_unetpp.TRAIN_REMAT_SAVE_NAMES) if blocks else 0)
    assert_step(runs[1], runs[0], 1e-6)
    # Two moves would put each statistic 10% of the way further from its start.
    moved = {k: rel(runs[0][2][k], v.numpy()) for k, v in base.named_buffers() if "running" in k}
    assert max(moved.values()) > 1e-2


def test_autocast_gives_every_gradient_the_module_gives(unetpp):
    """Under bf16 autocast (the stages' default) the train form's convolutions run in
    bf16 and its BN in float32, as the module's: a float32 output close to the float32
    step's, a gradient on every parameter the module's step reaches (no cast detaches
    one), float32 running statistics."""
    _, base = unetpp
    x = torch.from_numpy(frames(2, 9, np.float32)).permute(0, 3, 1, 2)
    grads, outs = {}, {}
    for form in ("train", "module", "float32"):
        fa = copy.deepcopy(base).requires_grad_(True)
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=form != "float32"):
            out = fast_unetpp.make_fast_fa_apply(fa)(x, train=True) if form != "module" \
                else fa(x, train=True)
        assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
        out.square().mean().backward()
        grads[form] = {n: q.grad for n, q in fa.named_parameters() if q.grad is not None}
        assert all(t.dtype == torch.float32 for n, t in fa.named_buffers() if "running" in n)
        outs[form] = out.detach().numpy()
    errors = {form: rel(outs[form], outs["float32"]) for form in ("train", "module")}
    assert errors["train"] <= 1.5 * errors["module"], errors
    assert grads["train"].keys() == grads["module"].keys() == dict(base.named_parameters()).keys()
    for k, g in grads["train"].items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), k


def test_train_form_after_an_inference_mode_call(unetpp):
    """A train step after an eval call under ``torch.inference_mode`` (the serving path,
    then training, in one process): the constants the eval call left behind for the
    up2 kernels are not inference tensors, so autograd can save them."""
    _, base = unetpp
    fa = copy.deepcopy(base).requires_grad_(True)
    x = torch.from_numpy(frames(2, 11, np.float32)).permute(0, 3, 1, 2)
    apply = fast_unetpp.make_fast_fa_apply(fa)
    fast_unetpp._up2_mixing.cache_clear()
    with torch.inference_mode():
        apply(x)
    apply(x, train=True).square().mean().backward()
    assert all(q.grad is not None for q in fa.parameters())


@pytest.mark.parametrize("r", [2, 4])
def test_conv_wpack_matches_jax_and_the_plain_conv(r):
    """_conv_wpack (kept off every production path, as in the JAX package) against
    JAX's _conv_wpack and the plain SAME conv3x3."""
    rng = np.random.default_rng(r)
    x = rng.standard_normal((2, 12, 16, 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 6, 4)).astype(np.float32)
    got = fast_unetpp._conv_wpack(torch.from_numpy(x), torch.from_numpy(w), r, torch.float32)
    ref = np.asarray(jax_fast._conv_wpack(jnp.asarray(x), jnp.asarray(w), r, jnp.float32))
    plain = fast_unetpp.conv_nhwc(torch.from_numpy(x), torch.from_numpy(w), (1, 1),
                                  ((1, 1), (1, 1)), torch.float32)
    assert got.shape == ref.shape == (2, 12, 16, 4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The stages
# ---------------------------------------------------------------------------


def test_stages_run_the_train_form(unetpp, monkeypatch):
    """The fa pretraining step and the adversarial fa step (every remat mode) run the
    full-width UNet++'s train forwards through the train form, remat "blocks" with its
    pieces checkpointed; the fb/ft step's frozen fa runs the eval form."""
    _, base = unetpp
    seen = []
    real = fast_unetpp.fast_unetpp_train_apply
    monkeypatch.setattr(fast_unetpp, "fast_unetpp_train_apply",
                        lambda *a, **k: seen.append(k["remat_blocks"]) or real(*a, **k))
    fa = copy.deepcopy(base).requires_grad_(True)
    rng = np.random.default_rng(10)
    images = rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8)
    from ted_spad_tpu_torch.data.images import sample_image_augment_params

    draw = sample_image_augment_params(rng, 2, 40, SIDE, SIDE)
    step = fa_pretraining.make_train_step(fa, make_optimizer(fa.parameters(), "adam", 1e-3),
                                          (SIDE, SIDE), compute_dtype="float32", device="cpu")
    assert np.isfinite(float(step(images, draw)))
    assert seen == [False]

    fb = load_fb_model(ssl=True, tiny=True, dtype="float32", device="cpu").requires_grad_(True)
    ft = load_ft_model(tiny=True, num_classes=5, dropout_rate=0.0, dtype="float32",
                       device="cpu").requires_grad_(True)
    v1, v2 = (torch.from_numpy(rng.uniform(0, 1, (2, SIDE, SIDE, 3)).astype(np.float32))
              for _ in range(2))
    clips = torch.from_numpy(rng.uniform(0, 1, (2, 3, 8, SIDE, SIDE, 3)).astype(np.float32))
    labels = np.array([0, 1])
    for remat, want in (("off", False), ("on", False), ("blocks", True)):
        seen.clear()
        p = AnonymizationParams(num_classes=5, num_frames=8, reso_h=SIDE, reso_w=SIDE,
                                compute_dtype="float32", remat=remat)
        fa_step = anon.make_fa_step(fa, fb, ft, make_optimizer(fa.parameters(), "adam", 1e-3), p,
                                    device="cpu")
        assert np.isfinite(fa_step(v1, v2, clips, labels).numpy()).all()
        # v1, v2, the clips; under "on" each again in the backward's recompute
        assert seen == [want] * (6 if remat == "on" else 3), (remat, seen)
    seen.clear()
    fbft = anon.make_fbft_step(fa, fb, ft, make_optimizer(fb.parameters(), "adam", 1e-3),
                               make_optimizer(ft.parameters(), "adam", 1e-3), p, device="cpu")
    assert np.isfinite(fbft(v1, v2, clips, labels).numpy()).all()
    assert seen == []
