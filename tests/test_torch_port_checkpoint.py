"""Port parity for checkpoints: the port's flax-msgpack codec and checkpoint I/O
(ted_spad_tpu_torch/utils/msgpack_codec.py, utils/checkpoint.py) against flax and
the JAX package, in both directions, bit-exact; the codec's primitive encodings
against the installed ``msgpack`` package as the oracle; and the semantics of the
background writer and the best-metric checkpointer."""

import os

import flax.serialization
import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ted_spad_tpu.config.params import MGFNParams as JaxMGFNParams
from ted_spad_tpu.models import load_mgfn_model as jax_load_mgfn
from ted_spad_tpu.utils import checkpoint as jax_ckpt
from ted_spad_tpu_torch.config.params import MGFNParams
from ted_spad_tpu_torch.models import load_mgfn_model
from ted_spad_tpu_torch.utils import checkpoint as ckpt
from ted_spad_tpu_torch.utils import msgpack_codec
from ted_spad_tpu_torch.utils.jax_weights import load_jax_checkpoint, state_dict_to_flax

torch.set_num_threads(1)

SMALL = dict(feature_size=64, dims=(16, 32, 64), depths=(1, 1, 1), dim_head=16)


def jax_variables(seed: int = 0):
    """Perturbed numpy MGFN variables (every leaf off its init, BN statistics too)."""
    _, variables = jax_load_mgfn(JaxMGFNParams.for_dataset("UCF").replace(**SMALL), ncrops=1)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32) * rng.uniform(0.5, 1.5, np.shape(x))
                   + 0.1 * rng.standard_normal(np.shape(x))).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, variables))


def flat(tree) -> dict:
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_bit_equal(got, want):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(g, torch.Tensor):  # bfloat16 leaves
            g = g.view(torch.int16).numpy().view(np.uint16)
            w = np.asarray(w).view(np.uint16)
        assert np.asarray(g).dtype == np.asarray(w).dtype, key
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=key)


def mixed_payload(variables):
    return {"mgfn_model_state_dict": variables, "epoch": 7, "metric": 0.8123456789,
            "scalar": np.float32(1.5), "count": np.int64(-3), "flag": True, "note": "ok",
            "half": np.asarray(jnp.linspace(-2, 2, 12, dtype=jnp.bfloat16).reshape(3, 4))}


# ---------------------------------------------------------------------------
# flax -> port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 1024])
def test_jax_checkpoint_loads_bit_exact(tmp_path, monkeypatch, chunk):
    """A file from ted_spad_tpu's save_checkpoint (MGFN variables, int epoch, float
    metric, numpy scalars, a bfloat16 leaf; with chunk=1024 every leaf over 1 KiB is
    written as __msgpack_chunked_array__) loads bit-exact, and the MGFN weights land
    in the port's module exactly."""
    if chunk:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
    variables = jax_variables(0)
    payload = mixed_payload(variables)
    path = jax_ckpt.save_checkpoint(str(tmp_path / "jax.ckpt"), payload)
    if chunk:
        raw = msgpack.unpackb(open(path, "rb").read(), raw=False,
                              ext_hook=lambda code, data: msgpack.ExtType(code, data))
        assert raw["mgfn_model_state_dict"]["params"]["to_tokens"]["kernel"][
            "__msgpack_chunked_array__"]

    state = ckpt.load_checkpoint(path)
    assert state["epoch"] == 7 and type(state["epoch"]) is int
    assert state["metric"] == 0.8123456789 and type(state["metric"]) is float
    assert state["scalar"] == np.float32(1.5) and state["scalar"].dtype == np.float32
    assert state["count"] == -3 and state["count"].dtype == np.int64
    assert state["flag"] is True and state["note"] == "ok"
    assert state["half"].dtype == torch.bfloat16
    assert_trees_bit_equal({k: state[k] for k in ("mgfn_model_state_dict", "half")},
                           {k: payload[k] for k in ("mgfn_model_state_dict", "half")})

    model = load_mgfn_model(MGFNParams.for_dataset("UCF").replace(**SMALL),
                            saved_model_file=path, device="cpu")
    assert_trees_bit_equal(state_dict_to_flax(model), variables)


def test_bare_variables_file_loads(tmp_path):
    """A checkpoint holding bare variables (no model key) is accepted, as the JAX
    loaders accept it."""
    variables = jax_variables(1)
    path = jax_ckpt.save_checkpoint(str(tmp_path / "bare.ckpt"), variables)
    model = load_mgfn_model(MGFNParams.for_dataset("UCF").replace(**SMALL), device="cpu")
    load_jax_checkpoint(model, path, "mgfn_model_state_dict")
    assert_trees_bit_equal(state_dict_to_flax(model), variables)


# ---------------------------------------------------------------------------
# port -> flax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 1024])
def test_port_bytes_equal_flax_msgpack_serialize(monkeypatch, chunk):
    """For the same tree of numpy leaves (unsorted keys, scalars, bfloat16, nested
    lists) the port's bytes are flax.serialization.msgpack_serialize's, chunked
    leaves included; flax restores them."""
    if chunk:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", chunk)
    tree = {"zeta": mixed_payload(jax_variables(2)), "alpha": [1, 2.5, None, "s"],
            "ints": np.arange(-5, 300, dtype=np.int32), "empty": {}, "b": b"\x00\xff"}
    data = msgpack_codec.serialize(tree)
    assert data == flax.serialization.msgpack_serialize(tree)
    assert_trees_bit_equal(flax.serialization.msgpack_restore(data)["zeta"]["mgfn_model_state_dict"],
                           tree["zeta"]["mgfn_model_state_dict"])


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A trained port model's checkpoint: JAX's load_checkpoint + restore_like (through
    its load_mgfn_model) reads it bit-exact, and the bfloat16 leaf written from a torch
    tensor reads back as JAX's bfloat16."""
    p = MGFNParams.for_dataset("UCF").replace(**SMALL)
    model = load_mgfn_model(p, device="cpu")
    with torch.no_grad():
        for i, param in enumerate(model.parameters()):
            param.add_(0.01 * (i + 1))
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.fill_(1.7)
    half = torch.linspace(-1, 1, 6, dtype=torch.bfloat16)
    path = ckpt.save_checkpoint(str(tmp_path / "port.ckpt"),
                                {"mgfn_model_state_dict": state_dict_to_flax(model), "epoch": 2,
                                 "metric": 0.5, "half": half})
    _, restored = jax_load_mgfn(JaxMGFNParams.for_dataset("UCF").replace(**SMALL),
                                saved_model_file=path, ncrops=1)
    assert_trees_bit_equal(jax.tree_util.tree_map(np.asarray, restored), state_dict_to_flax(model))
    state = jax_ckpt.load_checkpoint(path)
    assert state["epoch"] == 2 and state["metric"] == 0.5
    assert state["half"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(state["half"].view(np.uint16),
                                  half.view(torch.int16).numpy().view(np.uint16))


# ---------------------------------------------------------------------------
# Primitive encodings, msgpack as the oracle
# ---------------------------------------------------------------------------

INT_BOUNDARIES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                  -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]


@pytest.mark.parametrize("value", INT_BOUNDARIES)
def test_int_encodings_match_msgpack(value):
    assert msgpack_codec.packb(value) == msgpack.packb(value)
    assert msgpack_codec.unpackb(msgpack.packb(value)) == value


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_container_encodings_match_msgpack(n):
    for obj in ("x" * n, b"y" * n, list(range(n)), {str(i): i for i in range(n)}):
        assert msgpack_codec.packb(obj) == msgpack.packb(obj, use_bin_type=True), (type(obj), n)
        assert msgpack_codec.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


@pytest.mark.parametrize("value", [0.0, -1.5, 3.25e-7, 1e300, float("inf")])
def test_float_encodings_match_msgpack(value):
    assert msgpack_codec.packb(value) == msgpack.packb(value)
    single = msgpack.packb(value, use_single_float=True)
    assert msgpack_codec.packb(value, use_single_float=True) == single
    assert msgpack_codec.unpackb(single) == msgpack.unpackb(single)


def test_codec_rejects_what_flax_cannot_write():
    with pytest.raises(TypeError):
        msgpack_codec.packb({1, 2})
    with pytest.raises(ValueError, match="trailing"):
        msgpack_codec.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        msgpack_codec.unpackb(msgpack.packb("abc")[:-1])


# ---------------------------------------------------------------------------
# Checkpoint semantics
# ---------------------------------------------------------------------------


def test_async_snapshot_is_isolated_from_in_place_updates(tmp_path):
    """save() copies on the caller: an in-place update of the live tensors after it
    (as optimizer.step() makes) does not reach the file. On the CPU a tensor's
    .numpy() shares memory, so without the copy it would."""
    w = ckpt.AsyncCheckpointWriter()
    model = load_mgfn_model(MGFNParams.for_dataset("UCF").replace(**SMALL), device="cpu")
    live = {"w": torch.arange(8, dtype=torch.float32), "n": np.arange(3, dtype=np.float32)}
    before = state_dict_to_flax(model)
    path = str(tmp_path / "a.ckpt")
    w.save(path, {"model": live, "mgfn_model_state_dict": before, "epoch": 3})
    live["w"].mul_(0.0)
    live["n"] *= 0.0
    with torch.no_grad():
        for param in model.parameters():
            param.add_(1.0)
    w.flush()
    state = ckpt.load_checkpoint(path)
    np.testing.assert_array_equal(state["model"]["w"], np.arange(8, dtype=np.float32))
    np.testing.assert_array_equal(state["model"]["n"], np.arange(3, dtype=np.float32))
    assert_trees_bit_equal(state["mgfn_model_state_dict"], before)
    assert state["epoch"] == 3


def test_same_path_saves_supersede(tmp_path):
    w = ckpt.AsyncCheckpointWriter()
    path = str(tmp_path / "temp.ckpt")
    for epoch in range(30):
        w.save(path, {"epoch": epoch})
    w.flush()
    assert ckpt.load_checkpoint(path)["epoch"] == 29
    ckpt.save_temp(str(tmp_path), "model", {"epoch": 7})
    assert ckpt.load_checkpoint(str(tmp_path / "model_temp.ckpt"))["epoch"] == 7


def test_flush_reraises_a_worker_error(tmp_path):
    """A write that fails on the worker (the target path is a directory) surfaces at
    flush(), once; the writer keeps working after it."""
    w = ckpt.AsyncCheckpointWriter()
    blocked = tmp_path / "blocked.ckpt"
    blocked.mkdir()
    (blocked / "inside").write_text("x")
    w.save(str(blocked), {"epoch": 1})
    with pytest.raises(OSError):
        w.flush()
    w.flush()
    w.save(str(tmp_path / "fine.ckpt"), {"epoch": 2})
    w.flush()
    assert ckpt.load_checkpoint(str(tmp_path / "fine.ckpt"))["epoch"] == 2


def test_best_checkpointer_names_and_selection_match_jax(tmp_path):
    """The same metric sequence gives the same files, names and best path in both
    packages; the files' payloads agree."""
    seq = [(0.5, 1), (0.4, 2), (0.91234, 3), (0.91234, 4), (0.95, 5)]
    ours = ckpt.BestCheckpointer(str(tmp_path / "port"), "mgfn_ucf")
    ref = jax_ckpt.BestCheckpointer(str(tmp_path / "jax"), "mgfn_ucf")
    for metric, epoch in seq:
        a = ours.maybe_save(metric, epoch, {"x": torch.full((3,), float(epoch))})
        b = ref.maybe_save(metric, epoch, {"x": np.full(3, float(epoch), np.float32)})
        assert (a is None) == (b is None)
        if a:
            assert os.path.basename(a) == os.path.basename(b)
    ckpt.flush_checkpoints()
    jax_ckpt.flush_checkpoints()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "mgfn_ucf_1_best_0.5000.ckpt", "mgfn_ucf_3_best_0.9123.ckpt", "mgfn_ucf_5_best_0.9500.ckpt"]
    assert os.path.basename(ours.best_path) == os.path.basename(ref.best_path)
    assert ours.best == ref.best == 0.95
    for name in os.listdir(tmp_path / "port"):
        a = ckpt.load_checkpoint(str(tmp_path / "port" / name))
        b = jax_ckpt.load_checkpoint(str(tmp_path / "jax" / name))
        assert (a["epoch"], a["metric"]) == (b["epoch"], b["metric"])
        np.testing.assert_array_equal(a["x"], b["x"])
    with open(tmp_path / "port" / "mgfn_ucf_5_best_0.9500.ckpt", "rb") as f1, \
            open(tmp_path / "jax" / "mgfn_ucf_5_best_0.9500.ckpt", "rb") as f2:
        assert f1.read() == f2.read()
