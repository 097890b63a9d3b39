"""Port parity of the I3Res50 train fast form (ted_spad_tpu_torch/ops/fast_i3d.py:
``make_fast_ft_train_forward``) against the JAX package's ops/fast_i3d.py, JAX's module
train apply and the port's module train forward, and the stages that run it.

The tiny I3Res50 with its head (``load_ft_model(tiny=True)``, dropout 0) on 4 clips of
8x32x32 of different brightness (the MLP head's train-mode BN then normalizes
well-spread embeddings), weights from the port's seeded init written out and perturbed
leaf by leaf (``test_torch_port_fullwidth.bridged``), given to both packages. The
forward is held on its logits and embeddings, every BN running statistic (the stem's
moved once, or with FrozenBN left as it was) and every parameter's gradient of a loss
that weighs each output by a seeded probe (the MLP head's fc1 bias, whose gradient its
BN removes, held absolutely: ``test_torch_port_fast_unetpp_train.live_grads``):

- float64 against the port's module train forward to 1e-8 of each tensor's norm;
- float64 against JAX's fast form and JAX's module to 1e-5: JAX's heads cast to
  float32 (the logits, and the embedding before its L2 normalization), which puts
  float32 rounding into both packages' comparison, 1.9e-6 of a gradient's norm at
  most in this test's steps (against the port's module: 6e-14);
- float32 against JAX's fast form, outputs and statistics at rtol / atol 2e-4 and
  gradients under the JAX package's robust metric
  (``test_torch_port_fast_unetpp_train.robust_ok``)."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_fast_unetpp_train import (
    F64_RTOL, assert_step, assert_step_f32, cast, jax_step, port_step, probes, rel,
)
from test_torch_port_fullwidth import bridged
from ted_spad_tpu.models import load_ft_model as jax_load_ft
from ted_spad_tpu.ops import fast_i3d as jax_fast
from ted_spad_tpu_torch.config.params import ActionParams, AnonymizationParams
from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model
from ted_spad_tpu_torch.ops import fast_i3d
from ted_spad_tpu_torch.ops.augment import sample_augment_params
from ted_spad_tpu_torch.stages import action_training
from ted_spad_tpu_torch.stages import anonymization_training as anon
from ted_spad_tpu_torch.stages.common import make_optimizer
from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables

torch.set_num_threads(1)

JAX_F64_RTOL = 1e-5  # JAX's float32 head casts
TINY_FT = dict(tiny=True, num_classes=5, dropout_rate=0.0)
CLIP = (8, 32, 32)
N = 4


@pytest.fixture(scope="module")
def tiny_ft():
    """(JAX module, the perturbed weights as a float32 flax tree, the port's ft)."""
    ft = load_ft_model(dtype="float32", device="cpu", **TINY_FT)
    jmodel = jax_load_ft(clip_shape=CLIP, dtype="float32", **TINY_FT)[0]
    variables = bridged(ft, jmodel, jnp.zeros((1,) + CLIP + (3,)), seed=21)
    return jmodel, variables, load_jax_variables(ft, variables)


def clips(seed: int, dtype=np.float64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    gain = np.array([0.2, 0.5, 0.8, 1.0])[:, None, None, None, None]
    return (rng.uniform(0, 1, (N,) + CLIP + (3,)) * gain).astype(dtype)


def _port_forward(frozen: bool, **kw):
    def fn(model, x):
        return list(fast_i3d.make_fast_ft_train_forward(model)(
            x.permute(0, 4, 1, 2, 3), frozen_bn=frozen, **kw))
    return fn


def _port_module(frozen: bool):
    def fn(model, x):
        return list(model(x.permute(0, 4, 1, 2, 3), train=True, frozen_bn=frozen))
    return fn


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen_bn", "batch_stats"])
def test_train_forward_matches_jax(tiny_ft, frozen):
    """make_fast_ft_train_forward against JAX's (and both modules') in float64 and
    against JAX's in float32; the stem's running statistics moved once from their
    start (0.9 ra + 0.1 of the batch's) or, with FrozenBN, left as they were."""
    jmodel, variables, ft = tiny_ft
    x = clips(1)
    weights = probes([(N, 5), (N, 128)], 2)
    stem0 = {k: v.double().numpy() for k, v in ft.i3d.stem.bn.named_buffers() if "running" in k}
    with torch.autograd.set_detect_anomaly(True):
        got = port_step(_port_forward(frozen), copy.deepcopy(ft).double(), x, weights)
    module = port_step(_port_module(frozen), copy.deepcopy(ft).double(), x, weights)
    got32 = port_step(_port_forward(frozen), copy.deepcopy(ft), x.astype(np.float32),
                      [w.astype(np.float32) for w in weights])

    def fast(p, t):
        (logits, emb), mut = jax_fast.make_fast_ft_train_forward(jmodel64)(
            {**v, "params": p}, t, frozen_bn=frozen)
        return [logits, emb], mut["batch_stats"]

    def jmodule(p, t):
        (logits, emb), mut = jmodel64.apply({**v, "params": p}, t, train=True, frozen_bn=frozen,
                                            mutable=["batch_stats"])
        return [logits, emb], mut["batch_stats"]

    with jax.enable_x64(True):
        jmodel64 = jax_load_ft(clip_shape=CLIP, dtype="float64", **TINY_FT)[0]
        v = cast(variables, np.float64)
        ref_fast = jax_step(fast, v["params"], jnp.asarray(x), weights)
        ref_module = jax_step(jmodule, v["params"], jnp.asarray(x), weights)
    jmodel64 = jmodel
    v = cast(variables, np.float32)
    ref32 = jax_step(fast, v["params"], jnp.asarray(x, jnp.float32),
                     [w.astype(np.float32) for w in weights])

    assert got[1]["i3d.stem.conv.weight"].any() and got[1]["i3d.stem.bn.weight"].any()
    assert_step(got, module, F64_RTOL)
    for ref in (ref_fast, ref_module):
        assert_step(got, ref, JAX_F64_RTOL)
    assert_step_f32(got32, ref32)
    for k, start in stem0.items():
        after = got[2][f"i3d.stem.bn.{k}"]
        if frozen:
            np.testing.assert_array_equal(after, start)
        else:  # moved once: a second move would put it 10% further from its start
            assert rel(after, start) > 1e-2
            np.testing.assert_allclose(after, ref_fast[2][f"i3d.stem.bn.{k}"], rtol=1e-10)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen_bn", "batch_stats"])
def test_remat_blocks_gives_the_same_step(tiny_ft, frozen, monkeypatch):
    """remat_blocks (the stem one more checkpointed piece, then the backbone's stages)
    gives the step without it: the same outputs and gradients, the running statistics
    moved once, no autograd anomaly."""
    _, _, ft = tiny_ft
    pieces = []
    real = fast_i3d.checkpoint
    monkeypatch.setattr(fast_i3d, "checkpoint", lambda fn, *a, **k: pieces.append(1) or real(fn, *a, **k))
    x = clips(3)
    weights = probes([(N, 5), (N, 128)], 4)
    off = port_step(_port_forward(frozen), copy.deepcopy(ft).double(), x, weights)
    with torch.autograd.set_detect_anomaly(True):
        on = port_step(_port_forward(frozen, remat_blocks=True), copy.deepcopy(ft).double(), x,
                       weights)
    assert pieces == [1]
    assert_step(on, off, 1e-12)


def _action_inputs(seed: int):
    """Two videos x 3 views of 8 x 40x48 uint8 frames of different brightness, their
    labels and an augmentation draw to 32^2."""
    rng = np.random.default_rng(seed)
    gain = np.array([0.3, 1.0])[:, None, None, None, None, None]
    raw = (rng.integers(0, 256, (2, 3, 8, 40, 48, 3)) * gain).astype(np.uint8)
    return raw, np.array([0, 3]), sample_augment_params(rng, 6, 40, 48, 32, 32)


def test_stages_run_the_train_form(tiny_ft, monkeypatch):
    """The action step runs the I3Res50 through the train form (its s2d stem conv, then
    FrozenBN), another family through its module; the adversarial fb/ft step through
    the train form too (the stem's BN on the batch's statistics), under every remat
    mode; the fa step's frozen ft runs the eval form (the folded s2d stem)."""
    _, _, base = tiny_ft
    calls = []
    for name in ("s2d_stem", "s2d_stem_conv"):
        real = getattr(fast_i3d, name)
        monkeypatch.setattr(fast_i3d, name,
                            lambda *a, _n=name, _r=real: calls.append((_n, torch.is_grad_enabled()))
                            or _r(*a))
    p = ActionParams(num_classes=5, num_frames=8, reso_h=32, reso_w=32, compute_dtype="float32",
                     temporal_loss="trip")
    raw, labels, draw = _action_inputs(5)
    ft = copy.deepcopy(base).requires_grad_(True)
    step = action_training.make_train_step(ft, make_optimizer(ft.parameters(), "adam", 1e-3), p,
                                           device="cpu")
    assert np.isfinite(float(step(raw, labels, draw)))
    assert calls == [("s2d_stem_conv", True)]
    calls.clear()
    r3d = load_ft_model("r3d_18", num_classes=5, dtype="float32", device="cpu").requires_grad_(True)
    rp = p.replace(arch="r3d_18")
    step = action_training.make_train_step(r3d, make_optimizer(r3d.parameters(), "adam", 1e-3), rp,
                                           generator=torch.Generator().manual_seed(0), device="cpu")
    assert np.isfinite(float(step(raw, labels, draw)))
    assert calls == []

    fa = load_fa_model(tiny=True, dtype="float32", device="cpu").requires_grad_(True)
    fb = load_fb_model(ssl=True, tiny=True, dtype="float32", device="cpu").requires_grad_(True)
    rng = np.random.default_rng(6)
    v1, v2 = (torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)) for _ in range(2))
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 8, 32, 32, 3)).astype(np.float32))
    for remat, n in (("off", 1), ("on", 2), ("blocks", 2)):
        q = AnonymizationParams(num_classes=5, num_frames=8, reso_h=32, reso_w=32,
                                compute_dtype="float32", remat=remat)
        fbft = anon.make_fbft_step(fa, fb, ft, make_optimizer(fb.parameters(), "adam", 1e-3),
                                   make_optimizer(ft.parameters(), "adam", 1e-3), q, device="cpu")
        assert np.isfinite(fbft(v1, v2, x, labels).numpy()).all()
        # the forward, and under "on" / "blocks" the backward's recompute
        assert calls == [("s2d_stem_conv", True)] * n, (remat, calls)
        calls.clear()
        fa_step = anon.make_fa_step(fa, fb, ft, make_optimizer(fa.parameters(), "adam", 1e-3), q,
                                    device="cpu")
        assert np.isfinite(fa_step(v1, v2, x, labels).numpy()).all()
        assert calls and {c[0] for c in calls} == {"s2d_stem"}, (remat, calls)
        calls.clear()
