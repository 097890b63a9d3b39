"""Data parallel in the port against one process, on the CPU: two gloo ranks, spawned as
subprocesses that meet through a FileStore under the test's temporary directory, run
the sharded steps, and each is held against the same step run in one process by the
port and by the JAX package:

- the MGFN train step (two Adam steps, two crops per video, so the crop-major features
  gather across ranks) and the scorer, in float64: ``mgfn_loss`` pairs the global
  half-batches;
- the I3Res50 action step ('ce', and 'con' with the NT-Xent temporal loss), against
  JAX's step on one device and sharded over the 8-device CPU mesh too
  (tests/test_parallel.py:59);
- steps with dropout on (MGFN's magnitude dropout; the I3Res50 head's) against the
  port's one-process step: each rank keeps its rows of the global mask;
- extraction: the ranks' shards are disjoint, complete and equal to a one-process run;
- the input pipeline: each rank's rows of a clip, VISPR or feature batch are the
  one-process batch's rows, and a batch with a failed decode runs replicated;
- the ``train_mgfn --mesh`` CLI: rank 0 alone writes, and the ranks stay bit-equal.

This file is also the ranks' program: ``python test_torch_port_multiprocess.py --rank R
--world W --store FILE --inputs FILE --out DIR`` runs every scenario of ``--inputs`` on
a gloo mesh and saves ``rank{R}.pt``. Limits, stated where they are used: float64
sharded against one-process steps to 1e-10 of a tensor's size (summation order only);
against JAX, the limits of test_torch_port_train_stages.py and
test_torch_port_mgfn_train.py.
"""

from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # the ranks run this file as a script
    sys.path.insert(0, REPO)

from ted_spad_tpu_torch.config.params import ActionParams, FeatureExtractionParams, MGFNParams  # noqa: E402
from ted_spad_tpu_torch.data import features as feature_data  # noqa: E402
from ted_spad_tpu_torch.data import images  # noqa: E402
from ted_spad_tpu_torch.data.videos import ClipDataset, VideoItem, synthetic_video_items  # noqa: E402
from ted_spad_tpu_torch.models import load_fa_model, load_ft_model, load_mgfn_model  # noqa: E402
from ted_spad_tpu_torch.ops.augment import AugmentParams  # noqa: E402
from ted_spad_tpu_torch.parallel import data_parallel_mesh, multihost  # noqa: E402
from ted_spad_tpu_torch.stages import action_training  # noqa: E402
from ted_spad_tpu_torch.stages.anomaly_detection import make_optimizer as mgfn_optimizer  # noqa: E402
from ted_spad_tpu_torch.stages.anomaly_detection import make_score_fn, make_train_step  # noqa: E402
from ted_spad_tpu_torch.stages.common import make_optimizer  # noqa: E402
from ted_spad_tpu_torch.stages.feature_extraction import extract_features  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
RANK_TIMEOUT_S = 300  # a rank that fails or hangs ends the test, never the suite
F64_RTOL = 1e-10  # sharded float64 step vs the one-process one: summation order only

MGFN_SMALL = dict(feature_size=32, dims=(8, 16, 32), depths=(1, 1, 1), dim_head=8,
                  batch_size=4, dropout_rate=0.0)
MGFN_B, MGFN_NCROPS, MGFN_SEG = 4, 2, 32
TINY_FT = dict(tiny=True, num_classes=5, dropout_rate=0.0)
ACTION_B = 8


# ---------------------------------------------------------------------------
# Spawning the ranks
# ---------------------------------------------------------------------------


def spawn_ranks(script: str, inputs: dict, out_dir: str, world: int = WORLD) -> list[dict]:
    """Save ``inputs``, run ``script`` as ``world`` gloo ranks over a FileStore in
    ``out_dir`` and return each rank's results. A rank that fails fails the test with
    every rank's output; one that hangs is killed at ``RANK_TIMEOUT_S``."""
    os.makedirs(out_dir, exist_ok=True)
    inputs_path = os.path.join(out_dir, "inputs.pt")
    torch.save(inputs, inputs_path)
    env = {k: v for k, v in os.environ.items() if k not in multihost.CLUSTER_MARKERS}
    env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, script, "--rank", str(r), "--world", str(world),
         "--store", os.path.join(out_dir, "store"), "--inputs", inputs_path, "--out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(world)]
    logs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=RANK_TIMEOUT_S)
            logs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for r, proc in enumerate(procs):
        assert proc.returncode == 0, f"rank {r} failed:\n" + "\n---\n".join(logs)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def rank_main(scenarios: dict) -> None:
    """A rank's program: join the gloo group, run each scenario of ``--inputs`` with
    the mesh, save the results."""
    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--store", "--inputs", "--out"):
        ap.add_argument(flag, required=True)
    args = ap.parse_args()
    multihost.initialize_distributed(f"file://{args.store}", args.world, args.rank,
                                     backend="gloo", timeout_s=RANK_TIMEOUT_S / 2)
    mesh = data_parallel_mesh("cpu")
    inputs = torch.load(args.inputs, weights_only=False)
    results = {name: scenarios[name](inp, mesh) for name, inp in inputs.items()}
    torch.save(results, os.path.join(args.out, f"rank{args.rank}.pt"))
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------


def close(a, b, rtol: float = F64_RTOL) -> bool:
    """max |a - b| <= rtol * max |b| (a tensor's size, not each element's)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and float(np.abs(a - b).max(initial=0.0)) <= rtol * max(
        float(np.abs(b).max(initial=0.0)), 1e-300)


def assert_same_tree(got: dict, want: dict, rtol: float = F64_RTOL, what: str = "") -> None:
    assert got.keys() == want.keys(), what
    for k in want:
        assert close(got[k], want[k], rtol), (what, k, np.abs(np.asarray(got[k], np.float64)
                                                              - np.asarray(want[k], np.float64)).max())


def named_grads(model: torch.nn.Module) -> dict:
    return {k: q.grad.detach().clone() for k, q in model.named_parameters() if q.grad is not None}


def state(model: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def assert_step_equal(got: dict, want: dict, lr: float, rtol: float = F64_RTOL) -> None:
    """A sharded step's record against the one-process one's: losses, every gradient,
    the state after the optimizer. A gradient that is zero in exact arithmetic (a bias
    ahead of a train-mode BatchNorm) is rounding noise in both runs: held absolutely,
    below 1e-9 of the step's largest gradient, and its Adam entries, which move by
    about +-lr on noise, to 2 lr; so are the entries of any gradient below that."""
    assert close(got["losses"], want["losses"], rtol), (got["losses"], want["losses"])
    for g_got, g_want in zip(got["grads"], want["grads"]):
        assert g_got.keys() == g_want.keys()
        floor = 1e-9 * max(float(g.abs().max()) for g in g_want.values())
        for k, g in g_want.items():
            if float(g.abs().max()) <= floor:
                assert float(g_got[k].abs().max()) <= floor, k
            else:
                assert close(g_got[k], g, rtol), (k, float((g_got[k] - g).abs().max()))
    grads = want["grads"][-1]
    floor = 1e-9 * max(float(g.abs().max()) for g in grads.values())
    for k, v in want["state"].items():
        g = grads.get(k)
        if g is None:
            assert close(got["state"][k], v, rtol), k
            continue
        noise = g.abs().numpy() <= floor
        d = np.abs(got["state"][k].numpy() - v.numpy())
        assert d[~noise].max(initial=0.0) <= rtol * float(v.abs().max()) + 1e-3 * lr, k
        assert d[noise].max(initial=0.0) <= 2 * lr, k


# ---------------------------------------------------------------------------
# Scenarios: each runs on a rank (mesh) or in one process (mesh=None)
# ---------------------------------------------------------------------------


def rows(mesh, x):
    return x if mesh is None else mesh.take_rows(x)


def run_mgfn(inp: dict, mesh) -> dict:
    """Two MGFN steps from ``inp["state"]`` in float64, then the scorer."""
    p = MGFNParams.for_dataset("UCF").replace(**inp["params"])
    model = load_mgfn_model(p, device="cpu").double()
    model.load_state_dict(inp["state"])
    model.requires_grad_(True)
    opt = mgfn_optimizer(model, p)
    gen = torch.Generator().manual_seed(5)
    step = make_train_step(model, opt, p, generator=gen, device="cpu", mesh=mesh)
    losses, grads = [], []
    for batch in inp["batches"]:
        losses.append(float(step(*(rows(mesh, x) for x in batch))))
        grads.append(named_grads(model))
    video, mask = inp["test"]
    scorer = copy.deepcopy(model).float()  # the scorer runs in float32
    scores = make_score_fn(scorer, device="cpu", mesh=mesh)(video, mask)
    return {"losses": np.asarray(losses), "grads": grads, "state": state(model),
            "scores": scores.numpy()}


def action_params(case: str) -> ActionParams:
    extra = {"ce": {}, "con": dict(loss="con", temporal_loss="con")}[case]
    return ActionParams(num_classes=5, num_frames=8, reso_h=32, reso_w=32, batch_size=ACTION_B,
                        compute_dtype="float32", learning_rate=1e-3, weight_decay=1e-2, **extra)


def run_action(inp: dict, mesh) -> dict:
    """One I3Res50 action step from ``inp["state"]`` in ``inp["dtype"]``."""
    p = action_params(inp["case"])
    ft = load_ft_model(dtype="float32", device="cpu", **dict(TINY_FT, dropout_rate=inp["dropout"]))
    ft.load_state_dict(inp["state"])
    ft.to(inp["dtype"]).requires_grad_(True)
    opt = make_optimizer(ft.parameters(), p.opt_type, p.learning_rate, p.weight_decay, p.momentum)
    gen = torch.Generator().manual_seed(3)
    step = action_training.make_train_step(ft, opt, p, generator=gen, device="cpu", mesh=mesh)
    clips, labels, draw = inp["clips"], inp["labels"], inp["draw"]
    if mesh is not None:
        draw = mesh.take_rows(draw, len(clips))  # each clip's views are consecutive rows
        clips, labels = mesh.take_rows(clips), mesh.take_rows(labels)
    loss = step(clips, labels, draw)
    return {"losses": np.asarray([float(loss)]), "grads": [named_grads(ft)], "state": state(ft)}


def run_extract(inp: dict, mesh) -> dict:
    p = FeatureExtractionParams(**inp["params"])
    fa = load_fa_model(tiny=True, dtype="float32", device="cpu", seed=1)
    ft = load_ft_model(dtype="float32", device="cpu", seed=2, clip_shape=(8, 32, 32), **TINY_FT)
    res = extract_features(p, inp["uris"], inp["out_dir"], fa=fa, ft=ft, batch_size=2,
                           decode_hw=(40, 80), num_workers=1, device="cpu", log_fn=lambda s: None,
                           mesh=mesh)
    return {k: res[k] for k in ("saved", "existing", "skipped", "clips")} | (
        {"shard": sorted(res["shard"]["saved"])} if mesh is not None else {})


def run_data(inp: dict, mesh) -> dict:
    """One epoch of each input pipeline: its batches as every rank holds them."""
    p = ActionParams(num_frames=8, reso_h=32, reso_w=32, num_classes=4)
    ds = ClipDataset([VideoItem(*it) for it in inp["items"]], p, views=3, num_workers=2, seed=1)
    try:
        clips = [(b.clips, b.labels, b.params, b.sharded)
                 for b in ds.batches(4, seed=2, mesh=mesh, parts=2 if mesh is not None else 1)]
    finally:
        ds.close()
    src = images.SyntheticImageSource(n=8, seed=0, canonical=40)
    vispr = [(b.images, b.labels, b.params, b.params2) for b in images.vispr_batches(
        src, 4, ssl=True, out_h=32, out_w=32, seed=3, mesh=mesh, parts=2)]
    saved, feature_data.ABNORMAL_SPLIT["UCF"] = feature_data.ABNORMAL_SPLIT["UCF"], 4
    try:  # the first 4 videos of the list are the abnormal ones
        normal = feature_data.FeatureDataset(inp["list"], "UCF", is_normal=True, seg_length=8)
        abnormal = feature_data.FeatureDataset(inp["list"], "UCF", is_normal=False, seg_length=8)
    finally:
        feature_data.ABNORMAL_SPLIT["UCF"] = saved
    feats = list(feature_data.paired_train_batches(normal, abnormal, 2, shuffle=True, seed=4,
                                                   mesh=mesh))
    return {"clips": clips, "vispr": vispr, "features": feats}


def run_cli(inp: dict, mesh) -> dict:
    """``train_mgfn --synthetic --mesh`` as torchrun would start it (the launcher's
    markers set; the group is already joined); without a mesh the one-process CLI."""
    from ted_spad_tpu_torch import train_mgfn

    save_dir = os.path.join(inp["out_dir"], f"rank{mesh.rank}" if mesh is not None else "one")
    argv = ["--synthetic", "--device", "cpu", "--epochs", "1", "--save_dir", save_dir]
    if mesh is not None:
        os.environ.update(RANK=str(mesh.rank), WORLD_SIZE=str(mesh.world_size))
        argv += ["--mesh", "--backend", "gloo"]
    res = train_mgfn.run(train_mgfn.parser().parse_args(argv))
    return {"history": res["history"], "save_dir": save_dir,
            "files": sorted(os.listdir(save_dir)) if os.path.isdir(save_dir) else [],
            "state": state(res["model"])}


SCENARIOS = {"mgfn": run_mgfn, "mgfn_dropout": run_mgfn, "action_ce": run_action,
             "action_con": run_action, "action_dropout": run_action, "extract": run_extract,
             "data": run_data, "cli": run_cli}


# ---------------------------------------------------------------------------
# Inputs, one-process references and the ranks' runs
# ---------------------------------------------------------------------------


def mgfn_batches(seed: int, n: int):
    """``n`` float64 (nfeat, nlabel, afeat, alabel) batches of (B, 2, 32, 33)
    segments with the magnitude channel; the abnormal half has a planted span."""
    from ted_spad_tpu_torch.ops.temporal import append_magnitude

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((2 * MGFN_B, MGFN_NCROPS, MGFN_SEG, 32))
        for i in range(MGFN_B, 2 * MGFN_B):
            s = int(rng.integers(0, MGFN_SEG - 4))
            x[i, :, s:s + 4] *= 4.0
        feats = append_magnitude(x.astype(np.float32)).astype(np.float64)
        out.append((feats[:MGFN_B], np.zeros(MGFN_B), feats[MGFN_B:], np.ones(MGFN_B)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs of every scenario, the one-process port runs, the JAX trees they start
    from, and the two ranks' runs."""
    import jax

    from test_torch_port_mgfn_train import perturbed
    from ted_spad_tpu.config.params import MGFNParams as JaxMGFNParams
    from ted_spad_tpu.models import load_mgfn_model as jax_load_mgfn
    from ted_spad_tpu.ops import augment as jax_augment
    from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables, state_dict_to_flax

    tmp = str(tmp_path_factory.mktemp("dp"))
    jax_trees: dict = {}

    # MGFN: perturbed JAX weights in the port's float64 model.
    jp = JaxMGFNParams.for_dataset("UCF").replace(**MGFN_SMALL)
    jvars = perturbed(jax_load_mgfn(jp, ncrops=MGFN_NCROPS)[1], 1)
    jax_trees["mgfn"] = jvars
    p = MGFNParams.for_dataset("UCF").replace(**MGFN_SMALL)
    mgfn_state = state(load_jax_variables(load_mgfn_model(p, device="cpu"), jvars).double())
    rng = np.random.default_rng(9)
    test = (rng.random((4, MGFN_NCROPS, 16, 33)).astype(np.float32), rng.random((4, 16)) < 0.8)
    test[1][:, 0] = True
    inputs = {"mgfn": dict(params=MGFN_SMALL, state=mgfn_state, batches=mgfn_batches(20, 2),
                           test=test)}
    inputs["mgfn_dropout"] = dict(inputs["mgfn"], params=dict(MGFN_SMALL, dropout_rate=0.3))

    # Action: perturbed tiny I3Res50, one seeded draw over 8 clips.
    from test_torch_port_train_stages import as_port_draw, bridged

    ft, ft_tree = bridged(load_ft_model(dtype="float32", device="cpu", **TINY_FT), 5)
    jax_trees["action"] = ft_tree
    rng = np.random.default_rng(7)
    for case in ("ce", "con"):
        v = action_training.views_for(action_params(case))
        gain = np.linspace(0.2, 1.0, ACTION_B)[:, None, None, None, None, None]
        clips = (rng.integers(0, 256, (ACTION_B, v, 8, 40, 48, 3)) * gain).astype(np.uint8)
        labels = np.array([0, 3, 0, 1, 2, 4, 3, 1], np.int32)
        draw = jax_augment.sample_augment_params(rng, ACTION_B * v, 40, 48, 32, 32)
        inputs[f"action_{case}"] = dict(case=case, state=state(ft), clips=clips, labels=labels,
                                        draw=as_port_draw(draw), dtype=torch.float64, dropout=0.0)
    inputs["action_dropout"] = dict(inputs["action_ce"], dropout=0.5)

    uris = [f"synthetic://n=40,h=40,w=80,seed={i}" for i in range(5)]
    ext = dict(num_frames=8, reso_h=32, reso_w=32, compute_dtype="float32", anonymized=True)
    inputs["extract"] = dict(params=ext, uris=uris, out_dir=os.path.join(tmp, "feat_dp"))

    items = [(it.uri, it.label) for it in synthetic_video_items(8, 4, num_frames=40, h=40, w=48)]
    items[5] = ("synthetic://broken", 1)  # fails to decode: its batch runs replicated
    feat_root = os.path.join(tmp, "feats")
    os.makedirs(feat_root)
    paths = []
    for i in range(8):
        path = os.path.join(feat_root, f"{'a' if i < 4 else 'n'}{i}.npy")
        np.save(path, np.random.default_rng(i).random((20, 16)).astype(np.float32))
        paths.append(path)
    with open(os.path.join(feat_root, "train.list"), "w") as f:
        f.write("\n".join(paths) + "\n")
    inputs["data"] = dict(items=items, list=os.path.join(feat_root, "train.list"))
    inputs["cli"] = dict(out_dir=os.path.join(tmp, "cli"))

    single = {}
    for name, inp in inputs.items():
        one = inp if name != "extract" else dict(inp, out_dir=os.path.join(tmp, "feat_one"))
        single[name] = SCENARIOS[name](copy.deepcopy(one), None)
    ranks = spawn_ranks(os.path.abspath(__file__), inputs, tmp)
    return inputs, single, ranks, jax_trees


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mgfn", "mgfn_dropout"])
def test_mgfn_sharded_step_is_the_one_process_step(runs, name):
    """Two float64 MGFN steps over 2 ranks (2 videos per half each, 2 crops): losses,
    every gradient and the state after Adam (BN statistics included) within 1e-10 of
    each tensor's size of the one-process steps, on both ranks; with dropout on the
    global masks make it so too. The scorer's gathered scores equal one process's."""
    _, single, ranks, _ = runs
    for r in ranks:
        assert_step_equal(r[name], single[name], lr=1e-3)
        assert close(r[name]["scores"], single[name]["scores"], 1e-6)


def test_mgfn_sharded_step_matches_jax(runs):
    """The sharded float64 MGFN steps against JAX's make_train_step in float32 from the
    same weights and batches at dropout 0: losses rel 1e-5, the state after the steps
    within 1e-3 of the update, batch_stats rel 1e-5 (test_torch_port_mgfn_train.py's
    limits); JAX's scorer with the trained state on the test batch within 1e-5."""
    import jax
    import jax.numpy as jnp

    from test_torch_port_mgfn_train import flat, rel
    from ted_spad_tpu.config.params import MGFNParams as JaxMGFNParams
    from ted_spad_tpu.models import load_mgfn_model as jax_load_mgfn
    from ted_spad_tpu.stages import anomaly_detection as jax_ad
    from ted_spad_tpu_torch.utils.jax_weights import state_dict_to_flax

    inputs, _, ranks, trees = runs
    jp = JaxMGFNParams.for_dataset("UCF").replace(**MGFN_SMALL)
    jmodel = jax_load_mgfn(jp, ncrops=MGFN_NCROPS)[0]
    optimizer = jax_ad.make_optimizer(jp)
    st = jax.tree_util.tree_map(jnp.asarray, trees["mgfn"])
    theta0 = flat(trees["mgfn"]["params"])
    ost = optimizer.init(st["params"])
    step = jax_ad.make_train_step(jmodel, optimizer, jp)
    jlosses = []
    for i, batch in enumerate(inputs["mgfn"]["batches"]):
        st, ost, loss = step(st, ost, jax.random.PRNGKey(i),
                             *(jnp.asarray(x, jnp.float32) for x in batch))
        jlosses.append(float(loss))
    video, mask = inputs["mgfn"]["test"]
    jscores = np.asarray(jax_ad.make_score_fn(jmodel)(st, jnp.asarray(video), jnp.asarray(mask)))
    for r in ranks:
        got = r["mgfn"]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
        model = load_mgfn_model(MGFNParams.for_dataset("UCF").replace(**MGFN_SMALL), device="cpu").double()
        model.load_state_dict(got["state"])
        ours = state_dict_to_flax(model)
        want = flat(st["params"])
        for k, v in flat(ours["params"]).items():
            update = np.linalg.norm(want[k].astype(np.float64) - theta0[k])
            assert np.linalg.norm(v - want[k]) <= 1e-3 * update, k
        want_stats = flat(st["batch_stats"])
        for k, v in flat(ours["batch_stats"]).items():
            assert rel(v, want_stats[k]) <= 1e-5, k
    np.testing.assert_allclose(ranks[0]["mgfn"]["scores"], jscores, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["action_ce", "action_con", "action_dropout"])
def test_action_sharded_step_is_the_one_process_step(runs, name):
    """One float64 I3Res50 action step over 2 ranks (4 clips each; FrozenBN backbone,
    the MLP head's BatchNorm over the global 8 x views rows; 'con': SupCon and
    NT-Xent over the gathered embeddings; dropout 0.5 in the head with the global
    mask) within 1e-10 of each tensor's size of the one-process step."""
    _, single, ranks, _ = runs
    for r in ranks:
        assert_step_equal(r[name], single[name], lr=1e-3)


@pytest.mark.parametrize("case", ["ce", "con"])
def test_action_sharded_step_matches_jax_sharded_step(runs, case):
    """The port's 2-rank float64 action step against JAX's make_train_step on the same
    clips, labels and draw, run on one device and sharded over the 8-device CPU mesh
    (tests/test_parallel.py:59), in float32 at dropout 0: JAX's two runs agree as
    test_parallel.py holds them (loss rel 1e-4, the first parameter 1e-4, statistics
    1e-3), and
    the port's step matches JAX's sharded one at test_torch_port_train_stages.py's
    limits (check_step: loss 1e-5, gradients 1e-4, Adam 1e-3 of the update,
    statistics 1e-5)."""
    import jax
    import jax.numpy as jnp

    from test_torch_port_train_stages import check_step, flat
    from ted_spad_tpu.config.params import ActionParams as JaxActionParams
    from ted_spad_tpu.models import load_ft_model as jax_load_ft
    from ted_spad_tpu.ops import augment as jax_augment
    from ted_spad_tpu.ops import losses as jax_losses
    from ted_spad_tpu.parallel import data_parallel_mesh as jax_mesh
    from ted_spad_tpu.parallel import replicate, shard_batch
    from ted_spad_tpu.stages import action_training as jax_action
    from ted_spad_tpu.stages.common import make_optimizer as jax_make_optimizer

    inputs, _, ranks, trees = runs
    inp = inputs[f"action_{case}"]
    p = action_params(case)
    jp = JaxActionParams(**{k: getattr(p, k) for k in ("num_classes", "num_frames", "reso_h", "reso_w",
                                                       "batch_size", "compute_dtype", "learning_rate",
                                                       "weight_decay", "loss", "temporal_loss")})
    jft = jax_load_ft(clip_shape=(8, 32, 32), dtype="float32", **TINY_FT)[0]
    tree = trees["action"]
    b, v = inp["clips"].shape[:2]
    draw = jax_augment.AugmentParams(**{k: getattr(inp["draw"], k) for k in AugmentParams.__dataclass_fields__})
    clips, labels = jnp.asarray(inp["clips"]), jnp.asarray(inp["labels"])

    def loss_fn(params):
        x = jax_augment.augment_batch(clips.reshape((b * v,) + clips.shape[2:]), draw.to_device(), 32, 32)
        (logits, emb), _ = jft.apply({**tree, "params": params}, x, train=True, frozen_bn=True,
                                     mutable=["batch_stats"])
        logits, emb = logits.reshape(b, v, -1)[:, 0], emb.reshape(b, v, -1)
        if p.loss == "con":
            loss = jax_losses.supcon_loss(jax_losses.l2_normalize(emb[:, :2], axis=-1), labels)
        else:
            loss = jax_losses.cross_entropy_loss(logits, labels)
        if p.temporal_loss == "con":
            loss += p.temporal_loss_weight * jax_losses.nt_xent_loss(emb[:, 0], emb[:, 1])
        return loss

    jgrads = flat(jax.jit(jax.grad(loss_fn))(tree["params"]))
    optimizer = jax_make_optimizer(jp.opt_type, jp.learning_rate, jp.weight_decay, jp.momentum)
    jstep = jax_action.make_train_step(jft, optimizer, jp)
    dup = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731 -- the step donates
    n1, _, loss1 = jstep(dup(tree), optimizer.init(dup(tree)["params"]), jax.random.PRNGKey(0),
                         clips, labels, draw.to_device())
    mesh = jax_mesh()
    sh = lambda x: shard_batch(mesh, x)  # noqa: E731
    state8 = replicate(mesh, dup(tree))
    n8, _, loss8 = jstep(state8, replicate(mesh, optimizer.init(state8["params"])),
                         jax.random.PRNGKey(0), sh(clips), sh(labels), jax.tree_util.tree_map(sh, draw.to_device()))
    assert float(loss8) == pytest.approx(float(loss1), rel=1e-4)
    np.testing.assert_allclose(np.asarray(jax.tree_util.tree_leaves(n8["params"])[0]),
                               np.asarray(jax.tree_util.tree_leaves(n1["params"])[0]),
                               rtol=1e-4, atol=1e-6)
    for a, c in zip(jax.tree_util.tree_leaves(n8["batch_stats"]), jax.tree_util.tree_leaves(n1["batch_stats"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c), rtol=1e-3, atol=1e-5)
    n8 = jax.tree_util.tree_map(np.asarray, n8)
    for r in ranks:
        got = r[f"action_{case}"]
        ft = load_ft_model(dtype="float32", device="cpu", **TINY_FT).double()
        ft.load_state_dict(got["state"])
        for k, q in ft.named_parameters():
            q.grad = got["grads"][0][k]
        check_step(ft, got["losses"][0], loss8, jgrads, flat(tree["params"]), n8["params"],
                   n8["batch_stats"], coupled_decay=p.weight_decay)


def test_extraction_shards_are_disjoint_complete_and_the_one_process_run(runs):
    """Two ranks extract 5 videos: rank 0 the 1st, 3rd and 5th, rank 1 the others
    (process_shard), no video in both, every video once; each rank returns the whole
    run's map; every feature file equals the one-process run's (rel 1e-5: the ranks'
    batches hold other clips beside each one)."""
    inputs, single, ranks, _ = runs
    uris = inputs["extract"]["uris"]
    assert ranks[0]["extract"]["shard"] == sorted(uris[0::2])
    assert ranks[1]["extract"]["shard"] == sorted(uris[1::2])
    for r in ranks:
        assert sorted(r["extract"]["saved"]) == sorted(uris)
        assert r["extract"]["clips"] == single["extract"]["clips"]
        assert not r["extract"]["skipped"]
    for uri, path in single["extract"]["saved"].items():
        got = np.load(ranks[0]["extract"]["saved"][uri])
        want = np.load(path)
        assert os.path.basename(path) == os.path.basename(ranks[1]["extract"]["saved"][uri])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_input_pipelines_give_each_rank_its_rows(runs):
    """Clip batches (3 views, 2 microbatches' layout): each rank decodes only its rows
    and holds exactly the one-process batch's rows and draws; the batch with the
    undecodable video runs replicated (both ranks hold the one-process batch). VISPR
    and feature batches: each rank's rows of the same global order."""
    _, single, ranks, _ = runs
    from ted_spad_tpu_torch.parallel.mesh import DataParallelMesh

    for r, res in enumerate(ranks):
        mesh = DataParallelMesh(WORLD, r, torch.device("cpu"), "gloo")
        want_clips = single["data"]["clips"]
        assert len(res["data"]["clips"]) == len(want_clips) == 2
        sharded = [c[3] for c in res["data"]["clips"]]
        assert sharded == [True, False]  # the second batch holds the broken video
        for (clips, labels, aug, shd), (wc, wl, wa, _) in zip(res["data"]["clips"], want_clips):
            if shd:
                wc, wl, wa = (mesh.take_rows(wc, parts=2), mesh.take_rows(wl, parts=2),
                              mesh.take_rows(wa, len(wc), parts=2))
            np.testing.assert_array_equal(clips, wc)
            np.testing.assert_array_equal(labels, wl)
            for f in AugmentParams.__dataclass_fields__:
                np.testing.assert_array_equal(getattr(aug, f), getattr(wa, f))
        for got, want in zip(res["data"]["vispr"], single["data"]["vispr"]):
            np.testing.assert_array_equal(got[0], mesh.take_rows(want[0], parts=2))
            np.testing.assert_array_equal(got[1], mesh.take_rows(want[1], parts=2))
            for i in (2, 3):
                for f in AugmentParams.__dataclass_fields__:
                    np.testing.assert_array_equal(getattr(got[i], f),
                                                  getattr(mesh.take_rows(want[i], parts=2), f))
        assert len(res["data"]["features"]) == len(single["data"]["features"]) == 2
        for got, want in zip(res["data"]["features"], single["data"]["features"]):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, mesh.take_rows(w))


def test_train_mgfn_cli_mesh_writes_on_rank_zero_only(runs):
    """``train_mgfn --synthetic --mesh --backend gloo`` on 2 ranks: rank 0 writes the
    checkpoints and metrics the one-process CLI writes (a best and a final checkpoint,
    the metrics), rank 1 writes nothing, and the two ranks end bit-equal (history and
    model). Their numbers are not held against the one-process CLI's: the CLI starts
    from the seeded init, where every token leaves ``to_logits_norm`` with the same
    magnitude and float32 rounding picks the top-k (the scenario tests above start
    from perturbed weights and hold the values)."""
    _, single, ranks, _ = runs
    one = single["cli"]
    kinds = lambda files: sorted(f.split("_best_")[0] + ("_best" if "_best_" in f else "")  # noqa: E731
                                 for f in files)
    assert "mgfn_synth_final.ckpt" in one["files"]
    assert kinds(ranks[0]["cli"]["files"]) == kinds(one["files"])
    assert not any(f.endswith(".ckpt") for f in ranks[1]["cli"]["files"])
    assert ranks[0]["cli"]["history"] == ranks[1]["cli"]["history"]
    assert np.isfinite(ranks[0]["cli"]["history"]["loss"]).all()
    assert_same_tree(ranks[1]["cli"]["state"], ranks[0]["cli"]["state"], 0.0, "cli")


if __name__ == "__main__":
    rank_main(SCENARIOS)
