"""Data parallel in the port's adversarial stage against one process, on the CPU: two
gloo ranks (spawned as test_torch_port_multiprocess.py spawns them) run the fa step and
the fb/ft step from bridged weights in float64, each held against the same step run in
one process by the port and by the JAX package:

- the fa step under ``accum_steps=2``: each rank holds its block of each global
  microbatch, the fa's BatchNorm takes each microbatch's global statistics through
  its three chained forwards, NT-Xent contrasts the microbatch's global VISPR rows;
- the fa step with SupCon and quirk_compat (the scrambled clip view, per video), against
  the port's one-process step (test_torch_port_adversarial.py holds that one against
  JAX);
- the fb/ft step ('ce'): fb's BatchNorm and NT-Xent over the global pairs, the ft's
  head over the global clips;
- the fb/ft step with the ft's dropout on, its rows laid out in the fa step's two
  microbatches: the gathered rows come back in global order and each rank keeps its
  rows of the global mask (against the port's one-process step);
- one epoch of ``train_anonymizer(mesh=)`` (a fa step and a fb/ft step): rank 0 alone
  writes, the ranks end bit-equal, and the epoch's losses are the one-process run's.

This file is also the ranks' program (test_torch_port_multiprocess.rank_main). Limits:
sharded against one-process steps, 1e-10 of a tensor's size (float64, summation order
only); against JAX, test_torch_port_train_stages.py's check_step limits in float64, as
test_torch_port_adversarial.py holds the one-process steps.
"""

from __future__ import annotations

import copy
import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_port_multiprocess import (  # noqa: E402
    assert_same_tree, assert_step_equal, named_grads, rank_main, spawn_ranks, state,
)

from ted_spad_tpu_torch.config.params import AnonymizationParams  # noqa: E402
from ted_spad_tpu_torch.data import images  # noqa: E402
from ted_spad_tpu_torch.data.videos import synthetic_video_items  # noqa: E402
from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model  # noqa: E402
from ted_spad_tpu_torch.stages import anonymization_training as anon  # noqa: E402
from ted_spad_tpu_torch.stages.common import make_optimizer  # noqa: E402

torch.set_num_threads(1)

SIDE, T = 32, 8
COMMON = dict(num_classes=5, num_frames=T, reso_h=SIDE, reso_w=SIDE, compute_dtype="float32",
              learning_rate=1e-3, remat="off")
CASES = {
    "fa_accum2": dict(accum_steps=2),
    "fa_con_quirk": dict(loss="con", quirk_compat=True),
    "fbft_ce": dict(),
    "fbft_dropout_accum2": dict(accum_steps=2),
}
TINY_FT = dict(tiny=True, num_classes=5)


def models(inp: dict):
    fa = load_fa_model(tiny=True, dtype="float32", device="cpu")
    fb = load_fb_model(ssl=True, tiny=True, dtype="float32", device="cpu")
    ft = load_ft_model(dtype="float32", device="cpu", dropout_rate=inp["dropout"], **TINY_FT)
    for m, sd in zip((fa, fb, ft), inp["states"]):
        m.double().load_state_dict(sd)
        m.requires_grad_(True)
    return fa, fb, ft


def run_step(inp: dict, mesh) -> dict:
    """One fa or fb/ft step from ``inp["states"]`` in float64 on the global inputs
    (their rows in ``accum_steps`` microbatches on a rank)."""
    p = AnonymizationParams(**COMMON, **CASES[inp["case"]])
    fa, fb, ft = models(inp)
    batch = [torch.as_tensor(x) for x in inp["batch"]]
    if mesh is not None:
        batch = [mesh.take_rows(x, parts=p.accum_steps) for x in batch]
    if inp["case"].startswith("fa"):
        opt = make_optimizer(fa.parameters(), p.opt_type, p.learning_rate_fa, p.weight_decay)
        losses = anon.make_fa_step(fa, fb, ft, opt, p, device="cpu", mesh=mesh)(*batch)
        trained = {"fa": fa}
    else:
        opts = [make_optimizer(m.parameters(), p.opt_type, lr, p.weight_decay)
                for m, lr in ((fb, p.learning_rate_fb), (ft, p.learning_rate_ft))]
        gen = torch.Generator().manual_seed(4)
        losses = anon.make_fbft_step(fa, fb, ft, *opts, p, generator=gen, device="cpu",
                                     mesh=mesh)(*batch)
        trained = {"fb": fb, "ft": ft}
    out = {name: {"losses": losses.numpy(), "grads": [named_grads(m)], "state": state(m)}
           for name, m in trained.items()}
    out["frozen"] = {name: state(m) for name, m in (("fa", fa), ("fb", fb), ("ft", ft))
                     if name not in trained}
    return out


def run_driver(inp: dict, mesh) -> dict:
    """One synthetic epoch of train_anonymizer (tiny models, 4 videos and 4 VISPR
    pairs per batch, accum_steps=2): its history, files and models."""
    saved = {name: getattr(anon, name) for name in ("load_fa_model", "load_fb_model", "load_ft_model")}
    for name, fn in saved.items():
        setattr(anon, name, functools.partial(fn, tiny=True))
    save_dir = os.path.join(inp["out_dir"], "one" if mesh is None else f"rank{mesh.rank}")
    try:
        res = anon.train_anonymizer(
            AnonymizationParams(num_classes=4, num_frames=T, reso_h=SIDE, reso_w=SIDE, batch_size=4,
                                batch_size_vispr=4, v_batch_size=2, num_modes=1,
                                compute_dtype="float32", save_acc_threshold=-1.0, accum_steps=2,
                                run_id="adv"),
            train_items=synthetic_video_items(8, 4, num_frames=48, h=40, w=48, seed=0),
            val_items=synthetic_video_items(2, 4, num_frames=48, h=40, w=48, seed=1),
            vispr_source=images.SyntheticImageSource(n=8, canonical=48), save_dir=save_dir,
            max_epochs=1, log_fn=lambda s: None, device="cpu", mesh=mesh)
    finally:
        for name, fn in saved.items():
            setattr(anon, name, fn)
    run_dir = os.path.join(save_dir, "adv")
    return {"history": res["history"],
            "files": sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else [],
            "models": {k: state(res[k]) for k in ("fa", "fb", "ft")}}


def scenario(inp: dict, mesh) -> dict:
    return run_driver(inp, mesh) if inp["case"] == "driver" else run_step(inp, mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs (test_torch_port_adversarial's bridged tiny models and augmented
    inputs, widened to float64), the one-process port runs and the ranks' runs."""
    import jax

    from test_torch_port_adversarial import _inputs, _models

    tmp = str(tmp_path_factory.mktemp("dp_adv"))
    with jax.enable_x64(True):
        (fa, fb, ft), trees, _ = _models(dtype="float64", with_jax=False)
        (_, _, ft_drop), _, _ = _models(dropout_rate=0.5, dtype="float64", with_jax=False)
    states = [state(m) for m in (fa, fb, ft)]
    inputs = {}
    for case in CASES:
        v1, v2, clips, labels = _inputs(0 if case.startswith("fa") else 1)
        batch = tuple(a.astype(np.float64) for a in (v1, v2, clips)) + (labels,)
        drop = 0.5 if "dropout" in case else 0.0
        inputs[case] = dict(case=case, batch=batch, dropout=drop,
                            states=states[:2] + [state(ft_drop) if drop else states[2]])
    inputs["driver"] = dict(case="driver", out_dir=os.path.join(tmp, "driver"))
    single = {name: scenario(copy.deepcopy(inp), None) for name, inp in inputs.items()}
    ranks = spawn_ranks(os.path.abspath(__file__), inputs, tmp)
    return inputs, single, ranks, trees


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_is_the_one_process_step(runs, case):
    """Each step over 2 ranks against the one-process step, in float64: the losses,
    every gradient and the models after Adam (BN statistics included) within 1e-10 of
    each tensor's size, on both ranks; the models the step leaves alone unmoved."""
    _, single, ranks, _ = runs
    for r in ranks:
        for name, record in single[case].items():
            if name == "frozen":
                for model, sd in record.items():
                    assert_same_tree(r[case]["frozen"][model], sd, 0.0, model)
            else:
                assert_step_equal(r[case][name], record, lr=1e-3)


@pytest.mark.parametrize("case", ["fa_accum2", "fbft_ce"])
def test_sharded_step_matches_jax(runs, case):
    """The 2-rank step against JAX's make_fa_step (``_fa_step_accum`` under
    accum_steps=2) or make_fbft_step from the same bridged weights and inputs, in
    float64 at dropout 0: the losses rel 1e-5, and check_step's limits for each
    trained model's loss, gradients, Adam update and statistics."""
    import jax
    import jax.numpy as jnp

    from test_torch_port_adversarial import _dev, _with_grads
    from test_torch_port_train_stages import check_step, flat
    from ted_spad_tpu.config.params import AnonymizationParams as JaxAnonymizationParams
    from ted_spad_tpu.models import load_fa_model as jax_load_fa
    from ted_spad_tpu.models import load_fb_model as jax_load_fb
    from ted_spad_tpu.models import load_ft_model as jax_load_ft
    from ted_spad_tpu.stages import anonymization_training as jax_anon
    from ted_spad_tpu.stages.common import make_optimizer as jax_make_optimizer

    inputs, _, ranks, (fa_tree, fb_tree, ft_tree) = runs
    kw = dict(COMMON, **CASES[case])
    p, jp = AnonymizationParams(**kw), JaxAnonymizationParams(**kw)
    batch = inputs[case]["batch"]
    with jax.enable_x64(True):
        jfa = jax_load_fa(image_size=(SIDE, SIDE), dtype="float64", tiny=True)[0]
        jfb = jax_load_fb(ssl=True, tiny=True, image_size=(SIDE, SIDE), dtype="float64")[0]
        jft = jax_load_ft(clip_shape=(T, SIDE, SIDE), dtype="float64", dropout_rate=0.0, **TINY_FT)[0]
        if case.startswith("fa"):
            opt = _with_grads(jax_make_optimizer(p.opt_type, p.learning_rate_fa, p.weight_decay))
            step = jax_anon.make_fa_step(jfa, jfb, jft, opt, jp, accum_steps=p.accum_steps)
            st = _dev(fa_tree)
            new, (_, g), *jlosses = step(st, opt.init(st["params"]), _dev(fb_tree), _dev(ft_tree),
                                         jax.random.PRNGKey(0), *map(jnp.asarray, batch))
            want = {"fa": (new, g, fa_tree)}
        else:
            opt_fb = _with_grads(jax_make_optimizer(p.opt_type, p.learning_rate_fb, p.weight_decay))
            opt_ft = _with_grads(jax_make_optimizer(p.opt_type, p.learning_rate_ft, p.weight_decay))
            step = jax_anon.make_fbft_step(jfa, jfb, jft, opt_fb, opt_ft, jp)
            fbs, fts = _dev(fb_tree), _dev(ft_tree)
            new_fb, new_ft, (_, g_fb), (_, g_ft), *jlosses = step(
                _dev(fa_tree), fbs, fts, opt_fb.init(fbs["params"]), opt_ft.init(fts["params"]),
                jax.random.PRNGKey(0), *map(jnp.asarray, batch))
            want = {"fb": (new_fb, g_fb, fb_tree), "ft": (new_ft, g_ft, ft_tree)}
        want = {k: tuple(jax.tree_util.tree_map(np.asarray, t) for t in v) for k, v in want.items()}
        jlosses = np.asarray([float(x) for x in jlosses])
    builders = {"fa": lambda: load_fa_model(tiny=True, dtype="float32", device="cpu"),
                "fb": lambda: load_fb_model(ssl=True, tiny=True, dtype="float32", device="cpu"),
                "ft": lambda: load_ft_model(dtype="float32", device="cpu", dropout_rate=0.0, **TINY_FT)}
    for r in ranks:
        for col, (name, (new, grads, tree)) in enumerate(want.items()):
            got = r[case][name]
            np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
            model = builders[name]().double()
            model.load_state_dict(got["state"])
            for k, q in model.named_parameters():
                q.grad = got["grads"][0][k]
            check_step(model, got["losses"][col], jlosses[col],
                       flat(grads), flat(tree["params"]), new["params"], new["batch_stats"],
                       coupled_decay=p.weight_decay)


def test_driver_epoch_is_the_one_process_epoch(runs):
    """One epoch of train_anonymizer(mesh=) over 2 ranks (float32): rank 0 writes what
    the one-process run writes (the best and rolling checkpoints, the preview), rank 1
    no checkpoint; the ranks end bit-equal; the fa step's loss (from the same initial
    weights) within rel 1e-5 of the one-process run's, and the fb/ft step's (after the
    fa's update, whose float32 rounding Adam carries) within 1e-3."""
    _, single, ranks, _ = runs
    one = single["driver"]
    written = lambda files: [f for f in files if not f.startswith("events.")]  # noqa: E731
    assert written(ranks[0]["driver"]["files"]) == written(one["files"])
    assert "model_temp.ckpt" in one["files"]
    assert not any(f.endswith(".ckpt") for f in ranks[1]["driver"]["files"])
    assert ranks[0]["driver"]["history"] == ranks[1]["driver"]["history"]
    for name in ("fa", "fb", "ft"):
        assert_same_tree(ranks[1]["driver"]["models"][name], ranks[0]["driver"]["models"][name], 0.0, name)
    h, w = ranks[0]["driver"]["history"], one["history"]
    assert h["loss_fa"] == pytest.approx(w["loss_fa"], rel=1e-5)
    for k in ("loss_fb", "loss_ft", "loss_temporal"):
        assert h[k] == pytest.approx(w[k], rel=1e-3), k


if __name__ == "__main__":
    rank_main({name: scenario for name in list(CASES) + ["driver"]})
