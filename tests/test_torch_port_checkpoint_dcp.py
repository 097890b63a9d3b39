"""The port's asynchronous checkpoint backend over torch.distributed.checkpoint
(utils/checkpoint.py: dcp_checkpointer, save_checkpoint_dcp, load_checkpoint_dcp)
against the JAX package's orbax backend, on the CPU:

- a tiny adversarial stage's full-checkpoint payload (UNet++ fa, ResNet50SSL fb and
  I3Res50 ft as flax trees through the port's weight bridge, their Adam states after
  one step, the epoch) round-trips bit-equal, with and without a template, and its
  weight trees equal JAX's orbax round trip of the same trees;
- the caller's part copies the payload: in-place updates after ``save`` do not reach
  the file;
- a save to a path replaces the checkpoint there; ``wait`` re-raises a write error;
- two gloo ranks (spawned as tests/test_torch_port_multiprocess.py spawns them) save
  the replicated payload, write each tensor once, each loads it back equal, and one
  process loads what the two wrote.

This file is also the ranks' program (``--rank R --world W --store F --inputs F --out
D``). Every comparison is bit-equality."""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import pytest
import torch
from torch.distributed.checkpoint import CheckpointException

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.dirname(os.path.abspath(__file__))):
    if _p not in sys.path:  # the ranks run this file as a script
        sys.path.insert(0, _p)

from test_torch_port_multiprocess import rank_main, spawn_ranks  # noqa: E402

from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model  # noqa: E402
from ted_spad_tpu_torch.stages.anonymization_training import _optimizer_tree  # noqa: E402
from ted_spad_tpu_torch.utils import checkpoint  # noqa: E402
from ted_spad_tpu_torch.utils.jax_weights import load_jax_variables, state_dict_to_flax  # noqa: E402

torch.set_num_threads(1)

TINY_FT = dict(tiny=True, num_classes=5, dropout_rate=0.0)
SLOTS = ("fa", "fb", "ft")


def _jax_trees() -> dict:
    """The JAX package's seeded tiny fa, fb and ft variables (numpy leaves)."""
    import jax

    from ted_spad_tpu.models import load_fa_model as jax_fa
    from ted_spad_tpu.models import load_fb_model as jax_fb
    from ted_spad_tpu.models import load_ft_model as jax_ft

    trees = {"fa": jax_fa(image_size=(32, 32), tiny=True, dtype="float32")[1],
             "fb": jax_fb(ssl=True, tiny=True, image_size=(32, 32), dtype="float32")[1],
             "ft": jax_ft(clip_shape=(8, 32, 32), dtype="float32", **TINY_FT)[1]}
    return jax.tree_util.tree_map(np.asarray, trees)


def _payload(trees: dict, epoch: int = 4, seed: int = 0) -> tuple[dict, dict]:
    """(the adversarial stage's ``model_{E}_full.ckpt`` payload, the port's models):
    JAX's trees bridged into the port's tiny models, read back through the bridge,
    and each model's Adam state after one step on seeded gradients."""
    models = {"fa": load_fa_model(tiny=True, dtype="float32", device="cpu"),
              "fb": load_fb_model(ssl=True, tiny=True, dtype="float32", device="cpu"),
              "ft": load_ft_model(dtype="float32", device="cpu", **TINY_FT)}
    gen = torch.Generator().manual_seed(seed)
    payload = {}
    for slot, model in models.items():
        load_jax_variables(model, trees[slot])
        opt = torch.optim.Adam(model.parameters(), lr=1e-4, weight_decay=1e-5)
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
        payload[f"{slot}_model_state_dict"] = state_dict_to_flax(model)
        payload[f"opt_{slot}"] = _optimizer_tree(opt)
    payload["epoch"] = epoch
    return payload, models


def _same(got, want, path: str = "") -> None:
    """Bit-equal trees: the same keys, tensors and arrays equal with their dtype and
    kind (a tensor where a tensor was saved), other leaves equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, list(got)[:5], list(want)[:5])
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype, path
        assert torch.equal(got.cpu(), want.cpu()), path
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _bump(tree) -> None:
    """Add one, in place, to every tensor and array of ``tree`` (the optimizer trees
    hold the optimizer's own state tensors)."""
    for v in (tree.values() if isinstance(tree, dict) else tree if isinstance(tree, list) else ()):
        if isinstance(v, (torch.Tensor, np.ndarray)):
            v += 1
        else:
            _bump(v)


def _as_tensors(tree):
    """``tree`` as a load without a template gives it: numpy arrays as tensors."""
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tensors(v) for v in tree]
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


@pytest.fixture(scope="module")
def trees():
    return _jax_trees()


def test_payload_round_trips_bit_equal_and_equals_orbax(tmp_path, trees):
    from ted_spad_tpu.utils import checkpoint as jax_checkpoint

    payload, _ = _payload(trees)
    saved = copy.deepcopy(payload)
    ck = checkpoint.dcp_checkpointer()
    path = str(tmp_path / "model_3_full")
    assert checkpoint.save_checkpoint_dcp(ck, path, payload) == os.path.abspath(path)
    # The caller's part copied the payload: updates after save never reach the file.
    _bump(payload)
    payload = saved
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["model_3_full"]
    _same(checkpoint.load_checkpoint_dcp(ck, path, template=payload), payload)
    loaded = checkpoint.load_checkpoint_dcp(ck, path)
    _same(loaded, _as_tensors(payload))
    assert loaded["opt_fa"]["param_groups"][0]["betas"] == (0.9, 0.999)

    # JAX's orbax round trip of the same trees holds the same values (restored into
    # the trees as its template: the JAX package's restore without one does not run
    # under orbax 0.11's StandardRestore).
    import jax

    ock = jax_checkpoint.orbax_checkpointer()
    opath = str(tmp_path / "orbax")
    jax_trees = {f"{s}_model_state_dict": payload[f"{s}_model_state_dict"] for s in SLOTS}
    jax_checkpoint.save_checkpoint_orbax(ock, opath, jax_trees)
    ock.wait_until_finished()
    ref = jax.tree_util.tree_map(np.asarray, jax_checkpoint.load_checkpoint_orbax(ock, opath, jax_trees))
    for key in jax_trees:
        _same(jax.tree_util.tree_map(lambda t: t.numpy(), loaded[key]), ref[key])


def test_template_keeps_int_keys_devices_and_is_not_changed(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.BatchNorm1d(5))
    opt = torch.optim.Adam(model.parameters())
    model(torch.randn(4, 6)).sum().backward()
    opt.step()
    payload = {"model": model.state_dict(), "opt": opt.state_dict(), "epoch": 2, "metric": 0.75,
               "bf16": torch.arange(6, dtype=torch.bfloat16), "scalar": np.array(1.5, np.float32),
               "strided": np.arange(12, dtype=np.int64).reshape(3, 4).T}
    ck = checkpoint.dcp_checkpointer()
    path = str(tmp_path / "ck")
    checkpoint.save_checkpoint_dcp(ck, path, payload)
    template = {**payload, "model": {k: torch.zeros_like(v) for k, v in payload["model"].items()}}
    got = checkpoint.load_checkpoint_dcp(ck, path, template=template)
    _same(got, payload)
    assert all(not v.any() for v in template["model"].values())  # the template is untouched
    fresh = torch.optim.Adam(model.parameters())
    fresh.load_state_dict(got["opt"])  # int state keys: the optimizer takes it as saved
    assert torch.equal(fresh.state_dict()["state"][0]["exp_avg"], payload["opt"]["state"][0]["exp_avg"])
    meta = checkpoint.load_checkpoint_dcp(ck, path, device="cpu")
    assert list(meta["opt"]["state"]) == ["0", "1", "2", "3"] and meta["bf16"].dtype == torch.bfloat16
    assert meta["scalar"].shape == () and torch.equal(meta["strided"], torch.from_numpy(payload["strided"].copy()))


def test_save_replaces_and_wait_reraises(tmp_path):
    ck = checkpoint.dcp_checkpointer()
    path = str(tmp_path / "temp")
    checkpoint.save_checkpoint_dcp(ck, path, {"a": torch.ones(3), "b": torch.zeros(2), "epoch": 1})
    checkpoint.save_checkpoint_dcp(ck, path, {"a": torch.full((4,), 2.0), "epoch": 2})
    ck.wait()
    _same(checkpoint.load_checkpoint_dcp(ck, path), {"a": torch.full((4,), 2.0), "epoch": 2})
    assert sorted(os.listdir(tmp_path)) == ["temp"]

    def unpicklable():  # a local function: the background writer cannot pickle it
        return 0

    bad = str(tmp_path / "bad")
    checkpoint.save_checkpoint_dcp(ck, bad, {"a": torch.ones(2), "fn": unpicklable})
    with pytest.raises(CheckpointException, match="unpicklable"):
        ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["temp"]  # no partial directory is left
    ck.wait()  # the error was reported once; the checkpointer goes on working
    checkpoint.save_checkpoint_dcp(ck, path, {"a": torch.ones(1), "epoch": 3})
    _same(checkpoint.load_checkpoint_dcp(ck, path), {"a": torch.ones(1), "epoch": 3})


def _rank_save_load(inp: dict, mesh) -> dict:
    """Every rank saves the replicated payload and loads it back both ways."""
    ck = checkpoint.dcp_checkpointer()
    checkpoint.save_checkpoint_dcp(ck, inp["path"], inp["payload"])
    ck.wait()
    return {"template": checkpoint.load_checkpoint_dcp(ck, inp["path"], template=inp["payload"]),
            "metadata": checkpoint.load_checkpoint_dcp(ck, inp["path"]),
            "files": sorted(os.listdir(inp["path"]))}


SCENARIOS = {"dcp": _rank_save_load}


def test_two_ranks_save_once_and_load_equal(tmp_path, trees):
    payload, _ = _payload(trees, epoch=7, seed=1)
    path = str(tmp_path / "dp" / "model_6_full")
    results = spawn_ranks(os.path.abspath(__file__), {"dcp": {"path": path, "payload": payload}},
                          str(tmp_path / "ranks"))
    for r in results:
        _same(r["dcp"]["template"], payload)
        _same(r["dcp"]["metadata"], _as_tensors(payload))
    assert results[0]["dcp"]["files"] == results[1]["dcp"]["files"]
    assert sorted(os.listdir(tmp_path / "dp")) == ["model_6_full"]
    # Each tensor written once: the data files hold no more than one process writes.
    one = str(tmp_path / "one")
    ck = checkpoint.dcp_checkpointer()
    checkpoint.save_checkpoint_dcp(ck, one, payload)
    ck.wait()

    def data_bytes(d):
        return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d) if f.endswith(".distcp"))

    assert data_bytes(path) <= 1.05 * data_bytes(one)
    # One process loads what the two wrote.
    _same(checkpoint.load_checkpoint_dcp(ck, path, template=payload), payload)
    _same(checkpoint.load_checkpoint_dcp(ck, path), _as_tensors(payload))


if __name__ == "__main__":
    rank_main(SCENARIOS)
