"""Port parity for MGFN training: the losses, the train branch of the top-k
selection, Focus's BatchNorm in train mode and whole Adam steps, each against the
JAX package from the same (bridged) weights and the same batches.

Small widths (feature 64, dims (16, 32, 64), depths (1, 1, 1), dim_head 16, 4 videos
per half), float32 on the CPU. JAX's dropout mask cannot be drawn by torch, so the
step parity runs at dropout_rate 0 and the dropout's statistics are checked on their
own. Tolerances are stated per test; parameters after a step are held to the size
of the update itself, since where a gradient element is near 0 Adam's m/sqrt(v) is
near +-1 and a sign flip between the frameworks moves that element by +-lr."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ted_spad_tpu.config.params import MGFNParams as JaxMGFNParams
from ted_spad_tpu.models import load_mgfn_model as jax_load_mgfn
from ted_spad_tpu.models.mgfn import msnsd as jax_msnsd
from ted_spad_tpu.ops import losses as jax_losses
from ted_spad_tpu.stages.anomaly_detection import make_optimizer as jax_make_optimizer
from ted_spad_tpu.stages.anomaly_detection import make_train_step as jax_make_train_step
from ted_spad_tpu.stages.common import set_learning_rate as jax_set_learning_rate
from ted_spad_tpu_torch.config.params import MGFNParams
from ted_spad_tpu_torch.models import load_mgfn_model
from ted_spad_tpu_torch.models.mgfn import magnitude_dropout, msnsd
from ted_spad_tpu_torch.ops import losses
from ted_spad_tpu_torch.ops.temporal import append_magnitude
from ted_spad_tpu_torch.stages.anomaly_detection import make_optimizer, make_train_step
from ted_spad_tpu_torch.stages.common import set_learning_rate
from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables, state_dict_to_flax

torch.set_num_threads(1)

SMALL = dict(feature_size=64, dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16, batch_size=4,
             dropout_rate=0.0)
BATCH, SEG = 4, 32


def perturbed(variables, seed: int):
    """numpy copy of a flax variables tree with every leaf moved off its init."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x * rng.uniform(0.8, 1.2, x.shape) + 0.05 * rng.standard_normal(x.shape)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, variables))


def flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / np.linalg.norm(np.asarray(b, np.float64)))


def train_batch(seed: int):
    """(nfeat, nlabel, afeat, alabel): (B, 1, 32, 65) segments with the magnitude
    channel; the abnormal half carries a planted high-magnitude span."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2 * BATCH, SEG, 64)).astype(np.float32)
    for i in range(BATCH, 2 * BATCH):
        s = int(rng.integers(0, SEG - 4))
        x[i, s:s + 4] *= 4.0
    feats = append_magnitude(x)[:, None]
    return (feats[:BATCH], np.zeros(BATCH, np.float32), feats[BATCH:],
            np.ones(BATCH, np.float32))


def models(seed: int):
    jp = JaxMGFNParams.for_dataset("UCF").replace(**SMALL)
    jmodel, jvars = jax_load_mgfn(jp, ncrops=1)
    jvars = perturbed(jvars, seed)
    p = MGFNParams.for_dataset("UCF").replace(**SMALL)
    model = load_jax_variables(load_mgfn_model(p, device="cpu"), jvars).requires_grad_(True)
    return jp, jmodel, jvars, p, model


def port_grads(model) -> dict:
    """The module's gradients in the flax layout (a copy whose weights are the grads)."""
    g = copy.deepcopy(model)
    for (_, dst), (_, src) in zip(g.named_parameters(), model.named_parameters()):
        dst.data = src.grad.detach().clone()
    return flat(state_dict_to_flax(g)["params"])


def jax_loss_fn(jmodel, jp, batch_stats, nfeat, nlabel, afeat, alabel):
    """The loss of JAX's make_train_step (stages/anomaly_detection.py:81-110), for
    its gradient."""
    video = jnp.concatenate([nfeat, afeat], axis=0)

    def loss_fn(params):
        outs, _ = jmodel.apply({"params": params, "batch_stats": batch_stats}, video, train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        sa, sn, afm, nfm, scores = outs
        abn = scores.reshape(-1)[BATCH * scores.shape[1]:]
        return (jax_losses.mgfn_loss(sn, sa, nlabel, alabel, nfm, afm, margin=jp.contrastive_margin)
                + jax_losses.smoothness_loss(abn, jp.lambda_smooth)
                + jax_losses.sparsity_loss(abn, jp.lambda_sparse))

    return loss_fn


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def test_losses_match_jax():
    """Every MGFN loss term against ted_spad_tpu.ops.losses: rel 1e-6."""
    rng = np.random.default_rng(0)
    scores = rng.uniform(0, 1, (BATCH * SEG,)).astype(np.float32)
    sn, sa = rng.uniform(0, 1, (2, BATCH, 1)).astype(np.float32)
    nl, al = np.zeros(BATCH, np.float32), np.ones(BATCH, np.float32)
    nfm, afm = rng.standard_normal((2, 2 * BATCH, 3, 64)).astype(np.float32) * 5
    t = torch.from_numpy
    cases = [
        (losses.bce_loss(t(sn.ravel()), t(nl)), jax_losses.bce_loss(sn.ravel(), nl)),
        (losses._pairwise_distance(t(nfm[:, 0]), t(afm[:, 0])),
         jax_losses._pairwise_distance(nfm[:, 0], afm[:, 0])),
        (losses.sparsity_loss(t(scores), 8e-3), jax_losses.sparsity_loss(scores, 8e-3)),
        (losses.smoothness_loss(t(scores), 8e-4), jax_losses.smoothness_loss(scores, 8e-4)),
        (losses.magnitude_contrastive_loss(t(nfm[:, :, 0]), t(afm[:, :, 0]), 1.0, 20.0),
         jax_losses.magnitude_contrastive_loss(nfm[:, :, 0], afm[:, :, 0], 1.0, 20.0)),
        (losses.magnitude_contrastive_loss(t(nfm[:, :, 0]), t(afm[:, :, 0]), 0.0),
         jax_losses.magnitude_contrastive_loss(nfm[:, :, 0], afm[:, :, 0], 0.0)),
        (losses.mgfn_loss(t(sn), t(sa), t(nl), t(al), t(nfm), t(afm)),
         jax_losses.mgfn_loss(sn, sa, nl, al, nfm, afm)),
    ]
    for ours, ref in cases:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Model pieces in train mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ncrops", [1, 2])
def test_msnsd_train_branch_matches_jax(ncrops):
    """The [normal; abnormal] selection at dropout 0: the selected features are the
    very rows JAX picks (bit-equal, so the indices agree), scores rel 1e-6."""
    rng = np.random.default_rng(ncrops)
    feats = rng.standard_normal((2 * BATCH * ncrops, SEG, 24)).astype(np.float32)
    scores = rng.uniform(0, 1, (2 * BATCH * ncrops, SEG, 1)).astype(np.float32)
    ref = jax_msnsd(jnp.asarray(feats), jnp.asarray(scores), ncrops, 3, lambda ones: ones,
                    inference=False)
    ours = msnsd(torch.from_numpy(feats), torch.from_numpy(scores), ncrops, 3, inference=False)
    assert [tuple(o.shape) for o in ours] == [r.shape for r in ref] == [
        (BATCH, 1), (BATCH, 1), (ncrops * BATCH, 3, 24), (ncrops * BATCH, 3, 24),
        (2 * BATCH, SEG, 1)]
    for name, o, r in zip(("score_abnormal", "score_normal"), ours[:2], ref[:2]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(ours[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(ours[4].numpy(), np.asarray(ref[4]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("inference", [True, False])
def test_msnsd_ties_pick_as_lax_top_k(inference):
    """Videos with fewer than k = 3 non-zero token magnitudes (all-zero tokens tie at
    0): the picks are lax.top_k's, the lowest indices first among ties, so the
    selected features are the very rows JAX selects, in inference and in train mode."""
    rng = np.random.default_rng(7)
    ncrops, n = 2, 2 * BATCH
    feats = rng.standard_normal((n * ncrops, SEG, 8)).astype(np.float32)
    live = [[], [5], [3, 30], [0, 1, 2, 3], [31], [], [16, 17], [9]]  # non-zero tokens per video
    for v, keep in enumerate(live):
        mask = np.zeros(SEG, bool)
        mask[keep] = True
        feats[v * ncrops:(v + 1) * ncrops, ~mask] = 0.0
    scores = rng.uniform(0, 1, (n * ncrops, SEG, 1)).astype(np.float32)
    ref = jax_msnsd(jnp.asarray(feats), jnp.asarray(scores), ncrops, 3, lambda ones: ones,
                    inference=inference)
    ours = msnsd(torch.from_numpy(feats), torch.from_numpy(scores), ncrops, 3, inference=inference)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(ours[3].numpy(), np.asarray(ref[3]))
    for o, r in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=0)
    # torch.topk, which the port used before, picks other tied rows on these inputs.
    mag = torch.linalg.vector_norm(torch.from_numpy(feats), dim=2).reshape(n, ncrops, SEG).mean(1)
    assert not torch.equal(torch.topk(mag, 3, dim=1).indices.sort(dim=1).values,
                           torch.sort(mag, dim=1, descending=True, stable=True).indices[:, :3].sort(dim=1).values)


def test_focus_batch_norm_train_mode_matches_flax():
    """Three train-mode forwards move Focus's running statistics as flax's
    BatchNorm(momentum=0.9) does (biased variance): rel 1e-6 per tensor; the train
    outputs agree too (rel 1e-5)."""
    jp, jmodel, jvars, p, model = models(0)
    stats = jvars["batch_stats"]
    for step in range(3):
        nfeat, _, afeat, _ = train_batch(10 + step)
        video = np.concatenate([nfeat, afeat])
        outs, mutated = jmodel.apply({"params": jvars["params"], "batch_stats": stats},
                                     jnp.asarray(video), train=True,
                                     rngs={"dropout": jax.random.PRNGKey(step)},
                                     mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        with torch.no_grad():
            ours = model(torch.from_numpy(video), train=True)
        assert rel(ours[-1].numpy(), np.asarray(outs[-1])) <= 1e-5
    got, want = flat(state_dict_to_flax(model)["batch_stats"]), flat(stats)
    assert got.keys() == want.keys() and len(want) == 4  # mean and var of two Focus blocks
    for key in want:
        assert rel(got[key], want[key]) <= 1e-6, key
    # torch's own train-mode BatchNorm would have stored the unbiased variance.
    assert any(rel(got[k] * SEG * 2 * BATCH / (SEG * 2 * BATCH - 1), want[k]) > 1e-6
               for k in want if k.endswith("['var']"))


def test_magnitude_dropout_statistics():
    """flax Dropout(0.7) on ones: kept with p = 0.3 (share within 0.3 +- 0.02 over
    10^4 draws), kept values 1/0.3, the same seed the same mask, none at rate 0."""
    g = torch.Generator().manual_seed(5)
    mask = magnitude_dropout((100, 100), 0.7, g, torch.device("cpu"))
    kept = mask[mask != 0]
    assert abs(kept.numel() / mask.numel() - 0.3) <= 0.02
    np.testing.assert_allclose(kept.numpy(), np.float32(1 / 0.3), rtol=0, atol=0)
    again = magnitude_dropout((100, 100), 0.7, torch.Generator().manual_seed(5), torch.device("cpu"))
    assert torch.equal(mask, again)
    assert not torch.equal(mask, magnitude_dropout((100, 100), 0.7, g, torch.device("cpu")))
    assert magnitude_dropout((4, 4), 0.0, None, torch.device("cpu")) is None
    with pytest.raises(ValueError, match="Generator"):
        magnitude_dropout((4, 4), 0.7, None, torch.device("cpu"))


# ---------------------------------------------------------------------------
# Whole steps
# ---------------------------------------------------------------------------


def test_train_steps_match_jax_make_train_step():
    """Three steps of make_train_step from bridged weights against JAX's, with an LR
    change before the third (set_learning_rate on both sides), dropout 0:
    loss rel 1e-5; gradients ||d|| / ||g|| <= 1e-4 per tensor; parameters after each
    step ||d theta|| <= 1e-3 ||theta_t - theta_0|| per tensor; batch_stats rel 1e-5."""
    jp, jmodel, jvars, p, model = models(1)
    optimizer = jax_make_optimizer(jp)
    opt_state = optimizer.init(jvars["params"])
    jstep = jax_make_train_step(jmodel, optimizer, jp)
    opt = make_optimizer(model, p)
    step = make_train_step(model, opt, p, device="cpu")
    theta0 = flat(jvars["params"])
    state = jax.tree_util.tree_map(jnp.asarray, jvars)
    for i, lr in enumerate((1e-3, 1e-3, 3e-4)):
        batch = train_batch(20 + i)
        jax_set_learning_rate(opt_state, lr)
        set_learning_rate(opt, lr)
        jgrads = flat(jax.grad(jax_loss_fn(jmodel, jp, state["batch_stats"], *batch))(
            state["params"]))
        state, opt_state, jloss = jstep(state, opt_state, jax.random.PRNGKey(i),
                                        *map(jnp.asarray, batch))
        loss = step(*batch)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss)), (i, loss, jloss)

        grads = port_grads(model)
        assert grads.keys() == jgrads.keys()
        for key in jgrads:
            assert rel(grads[key], jgrads[key]) <= 1e-4, (i, key)

        ours = state_dict_to_flax(model)
        theta = flat(state["params"])
        got = flat(ours["params"])
        for key in theta:
            update = np.linalg.norm(theta[key].astype(np.float64) - theta0[key])
            assert update > 0, key
            assert np.linalg.norm(got[key].astype(np.float64) - theta[key]) <= 1e-3 * update, (i, key)
        want_stats = flat(state["batch_stats"])
        for key, value in flat(ours["batch_stats"]).items():
            assert rel(value, want_stats[key]) <= 1e-5, (i, key)


def test_float64_reference_step_stays_float64():
    """A float64 copy of the model runs the whole step in float64 (no float32
    narrowing inside the model or the losses) and agrees with the float32 step to
    float32 rounding: loss rel 1e-6, gradients ||d|| / ||g|| <= 1e-4 per tensor."""
    *_, p, model = models(3)
    wide = copy.deepcopy(model).double()
    batch = train_batch(40)
    with torch.no_grad():
        outs = wide(torch.from_numpy(np.concatenate([batch[0], batch[2]])).double(), train=True)
    assert all(o.dtype == torch.float64 for o in outs)
    wide = copy.deepcopy(model).double()
    losses_ = [make_train_step(m, make_optimizer(m, p), p, device="cpu")(*batch)
               for m in (model, wide)]
    assert losses_[1].dtype == torch.float64
    assert abs(float(losses_[0]) - float(losses_[1])) <= 1e-6 * abs(float(losses_[1]))
    g32, g64 = port_grads(model), port_grads(wide)
    for key in g64:
        assert rel(g32[key], g64[key]) <= 1e-4, key


def test_step_gate_tells_batches_apart():
    """The control of the card's step gate: the same weights on another batch give
    gradients far outside the 1e-4 limit."""
    *_, p, model = models(2)
    grads = []
    for seed in (30, 31):
        m = copy.deepcopy(model)
        make_train_step(m, make_optimizer(m, p), p, device="cpu")(*train_batch(seed))
        grads.append(port_grads(m))
    worst = max(rel(grads[1][k], grads[0][k]) for k in grads[0])
    assert worst > 1e-2
