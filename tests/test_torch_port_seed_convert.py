"""Parity of the port's seed conversion (ted_spad_tpu_torch/utils/torch_convert.py,
``convert_weights``) with ted_spad_tpu/utils/torch_convert.py, for the six seed kinds.

Reference-layout state_dicts come from the hand-built torch oracles of
tests/test_torch_convert.py and tests/test_torch_oracles.py (I3Res50, the ResNet-18
encoder, ResNet-50, R3D-18, a small MViTv2), BN statistics drawn off their init, and for
InceptionI3d, which has no oracle, and the full-width MViTv2-S from
``utils/reference_layout.reference_state_dict``. For each kind: the two packages'
converters give bit-equal arrays at the same key paths; the two ``convert_seed_payload``
agree bit for bit on the converted part and on key paths and shapes elsewhere (each
package keeps its own seeded init there); the oracle's float32 forward equals the port
model loaded from the port's converted file within 1e-4 of the output's largest
magnitude (features and logits); and a file written by either package's converter
loads in the other's ``load_*_model`` with equal forwards (same limit). torch on one
thread."""

from __future__ import annotations

import functools
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_convert import _torch_mvitv2, _torch_r3d18, _torch_resnet18_encoder, _torch_resnet50
from test_torch_oracles import _torch_i3res50
from test_torch_port_fullwidth import assert_close
from ted_spad_tpu import models as jax_models
from ted_spad_tpu.utils import checkpoint as jax_checkpoint
from ted_spad_tpu.utils import torch_convert as jax_tc
from ted_spad_tpu_torch import convert_weights
from ted_spad_tpu_torch.models import load_fa_model, load_fb_model, load_ft_model
from ted_spad_tpu_torch.models.mvit import MViTv2Config, MViTv2S
from ted_spad_tpu_torch.utils import torch_convert as tc
from ted_spad_tpu_torch.utils.checkpoint import save_checkpoint
from ted_spad_tpu_torch.utils.jax_weights import load_jax_checkpoint
from ted_spad_tpu_torch.utils.reference_layout import (
    SEED_FILES, reference_state_dict, write_dry_run_seeds,
)

torch.set_num_threads(1)

SMALL_MVIT = dict(depths=(1, 2), dims=(8, 16), heads=(1, 2), kv_strides=((1, 2, 2), (1, 1, 1)))
MVIT_CLIP = (2, 16, 16)  # full-width MViTv2-S at its smallest token grid
# Per kind: the class count the files are converted for and the clip the forwards run.
KINDS = {"largei3d": (400, (8, 32, 32)), "i3d": (400, (8, 32, 40)), "unet++": (102, None),
         "r50": (102, None), "r3d_18": (400, (8, 32, 32)), "mvitv2": (102, MVIT_CLIP)}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _perturbed(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """BN statistics off (0, 1) and zero vectors (biases, the class token) drawn, so an
    eval-mode forward reads every weight."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 0.4 + 0.8)
        for q in model.parameters():
            if q.ndim == 1 and q.abs().sum() == 0:
                q.copy_(torch.randn(q.shape, generator=g) * 0.02)
    return model.eval()


@functools.lru_cache(maxsize=None)
def oracle(kind: str) -> torch.nn.Module:
    """The torch oracle of a kind, seeded, eval mode (the MViTv2 one at SMALL_MVIT)."""
    torch.manual_seed(7)
    build = {"largei3d": lambda: _torch_i3res50(400), "unet++": _torch_resnet18_encoder,
             "r50": lambda: _torch_resnet50(1000), "r3d_18": lambda: _torch_r3d18(400),
             "mvitv2": lambda: _torch_mvitv2(input_thw=(4, 8, 8), num_classes=11, **SMALL_MVIT)}
    return _perturbed(build[kind](), seed=1)


@functools.lru_cache(maxsize=None)
def seed_sd(kind: str) -> dict:
    """The reference-layout state_dict each kind's payload and file tests convert."""
    if kind == "i3d":
        return reference_state_dict("i3d", seed=3)
    if kind == "mvitv2":
        return reference_state_dict("mvitv2", seed=4, clip_shape=MVIT_CLIP)
    return oracle(kind).state_dict()


def _converters(kind: str, nc: int):
    """(port converter, JAX converter) of a kind, called as the payload calls them."""
    calls = {
        "largei3d": lambda m: m.convert_i3res50(seed_sd(kind), include_fc=nc == 400),
        "i3d": lambda m: m.convert_inception_i3d(seed_sd(kind), include_logits=nc == 400),
        "unet++": lambda m: m.convert_resnet2d(seed_sd(kind), "resnet18", depth=4),
        "r50": lambda m: m.convert_resnet50_classifier(seed_sd(kind), replace_fc=False),
        "r3d_18": lambda m: m.convert_r3d18(seed_sd(kind), include_fc=nc == 400),
        "mvitv2": lambda m: m.convert_mvitv2(oracle("mvitv2").state_dict(), depths=(1, 2),
                                             include_head=True),
    }
    return calls[kind](tc), calls[kind](jax_tc)


@pytest.mark.parametrize("kind", list(KINDS))
def test_converters_match_jax_bit_for_bit(kind):
    ours, ref = _converters(kind, KINDS[kind][0])
    ours, ref = dict(_flat(ours)), dict(_flat(ref))
    assert ours.keys() == ref.keys() and len(ours) > 10
    for path in ref:
        assert ours[path].dtype == ref[path].dtype and np.array_equal(ours[path], ref[path]), path


@functools.lru_cache(maxsize=None)
def jax_payload(kind: str, nc: int) -> dict:
    clip = KINDS[kind][1]
    return jax_tc.convert_seed_payload(kind, seed_sd(kind), num_classes=nc,
                                       clip_shape=clip or (8, 32, 32), image_size=(32, 32))


# The prefix under which each kind's converted subtree sits in its payload's tree.
_PREFIX = {"largei3d": ("i3d",), "unet++": ("encoder",)}


@pytest.mark.parametrize("kind,nc", [("largei3d", 400), ("largei3d", 102), ("i3d", 400),
                                     ("unet++", 102), ("r50", 102), ("r3d_18", 400),
                                     ("mvitv2", 102)])
def test_seed_payload_matches_jax(kind, nc):
    """The converted part bit for bit; the template's part (each package's seeded init)
    by key paths and shapes. Below 400 classes the Kinetics fc is not converted."""
    ours = tc.convert_seed_payload(kind, seed_sd(kind), num_classes=nc, device="cpu",
                                   clip_shape=KINDS[kind][1])
    ref = jax_payload(kind, nc)
    assert ours.keys() == ref.keys()
    (key,) = ours
    ours, ref = dict(_flat(ours[key])), dict(_flat(ref[key]))
    assert ours.keys() == ref.keys()
    assert all(ours[p].shape == ref[p].shape for p in ref)
    sd = seed_sd(kind)
    tree = {"largei3d": lambda: tc.convert_i3res50(sd, include_fc=nc == 400),
            "i3d": lambda: tc.convert_inception_i3d(sd, include_logits=nc == 400),
            "unet++": lambda: tc.convert_resnet2d(sd, "resnet18", depth=4),
            "r50": lambda: tc.convert_resnet50_classifier(sd, replace_fc=True),
            "r3d_18": lambda: tc.convert_r3d18(sd, include_fc=nc == 400),
            "mvitv2": lambda: tc.convert_mvitv2(sd, include_head=nc == 400)}[kind]()
    prefix = _PREFIX.get(kind, ())
    conv = {(p[0],) + prefix + p[1:]: v for p, v in _flat(tree)}
    assert conv and set(conv) <= set(ours)
    for p, v in conv.items():
        assert np.array_equal(ours[p], v) and np.array_equal(ref[p], v), p
    heads = {"largei3d": ("params", "i3d", "fc", "kernel"), "i3d": ("params", "logits_conv", "kernel"),
             "r3d_18": ("params", "fc", "kernel"), "mvitv2": ("params", "head", "kernel")}
    if kind in heads:
        assert (heads[kind] in conv) == (nc == 400)
        assert ours[heads[kind]].shape[-1] == nc
    if kind == "unet++":  # encoder at depth 4: the trunk's layer4 is not read
        assert not any("layer4" in "/".join(p) for p in conv)
        assert any(p[1] == "x_0_0" for p in ours)  # the decoder keeps its init


@pytest.fixture()
def run_dir(tmp_path):
    """``tmp_path``, emptied when the test ends: these runs write full-width checkpoints
    (hundreds of MB to GBs), which pytest would otherwise keep for three sessions."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _convert_file(tmp_path, kind: str, sd: dict, nc: int) -> str:
    """The port's ``convert_weights`` CLI on a ``.pth`` holding ``sd``."""
    src, out = str(tmp_path / f"{kind}.pth"), str(tmp_path / f"{kind}_port.ckpt")
    torch.save(sd, src)
    return convert_weights.run(convert_weights.parser().parse_args(
        ["--kind", kind, "--src", src, "--out", out, "--num_classes", str(nc), "--device", "cpu"]))


def _assert_rel(ours: torch.Tensor, ref: torch.Tensor) -> None:
    """float32 forward parity: max |ours - ref| <= 1e-4 of max |ref|."""
    assert_close(ours.detach().numpy(), ref.detach().numpy())


@pytest.mark.parametrize("kind", ["largei3d", "unet++", "r50", "r3d_18", "mvitv2"])
def test_port_model_from_converted_file_matches_the_oracle(kind, run_dir):
    tm = oracle(kind)
    rng = np.random.default_rng(5)
    with torch.inference_mode():
        if kind == "largei3d":
            x = torch.from_numpy(rng.normal(0, 0.5, (1, 3, 8, 64, 64)).astype(np.float32))
            path = _convert_file(run_dir, kind, tm.state_dict(), 400)
            ft = load_ft_model("largei3d", saved_model_file=path, num_classes=400,
                               dtype="float32", device="cpu")
            (logits, feat), (ref_logits, ref_feat) = ft.i3d(x), tm(x)
            _assert_rel(feat, ref_feat)
            _assert_rel(ft.extract_features(x), ref_feat)
            _assert_rel(logits, ref_logits)
        elif kind == "unet++":
            x = torch.from_numpy(rng.normal(0, 0.5, (2, 3, 64, 64)).astype(np.float32))
            path = _convert_file(run_dir, kind, tm.state_dict(), 102)
            fa = load_fa_model("unet++", saved_model_file=path, dtype="float32", device="cpu")
            feats, ref = fa.encoder(x), tm.stages(x)
            assert len(feats) == len(ref) == 5
            for ours, theirs in zip(feats, ref):
                _assert_rel(ours, theirs)
        elif kind == "r50":
            x = torch.from_numpy(rng.normal(0, 0.5, (2, 3, 64, 64)).astype(np.float32))
            path = _convert_file(run_dir, kind, tm.state_dict(), 102)
            fb = load_fb_model(saved_model_file=path, dtype="float32", device="cpu")
            h = tm.maxpool(tm.relu(tm.bn1(tm.conv1(x))))
            for li in range(4):
                h = getattr(tm, f"layer{li + 1}")(h)
            _assert_rel(fb.backbone(x)[-1].mean(dim=(2, 3)), h.mean(dim=(2, 3)))
        elif kind == "r3d_18":
            x = torch.from_numpy(rng.normal(0, 0.5, (2, 3, 8, 32, 32)).astype(np.float32))
            path = _convert_file(run_dir, kind, tm.state_dict(), 400)
            ft = load_ft_model("r3d_18", saved_model_file=path, num_classes=400,
                               dtype="float32", device="cpu")
            logits, feat = ft(x)
            h = tm.stem(x)
            for li in range(4):
                h = getattr(tm, f"layer{li + 1}")(h)
            _assert_rel(feat, h.mean(dim=(2, 3, 4)))
            _assert_rel(logits, tm(x))
        else:  # the small oracle: its converted tree written as a checkpoint, then loaded
            x = torch.from_numpy(rng.normal(0, 0.5, (2, 3, 8, 32, 32)).astype(np.float32))
            tree = tc.convert_mvitv2(tm.state_dict(), depths=SMALL_MVIT["depths"], include_head=True)
            path = save_checkpoint(str(run_dir / "mvit.ckpt"), {"ft_model_state_dict": tree})
            ft = MViTv2S(11, MViTv2Config(**SMALL_MVIT), clip_shape=(8, 32, 32),
                         generator=torch.Generator().manual_seed(0)).eval()
            load_jax_checkpoint(ft, path, "ft_model_state_dict")
            logits, feat = ft(x)
            assert feat.shape == (2, SMALL_MVIT["dims"][-1])
            _assert_rel(logits, tm(x))


@functools.lru_cache(maxsize=None)
def jax_model(kind: str):
    """(the JAX package's seeded variables of a kind at KINDS' shapes, its jitted
    forward): I3Res50's feature, InceptionI3d's trunk, R3D-18's and MViTv2-S's logits
    and feature, the UNet++ output, the ResNet-50 classifier's logits."""
    nc, clip = KINDS[kind]
    if kind == "unet++":
        module, variables = jax_models.load_fa_model(image_size=(32, 32), dtype="float32")
    elif kind == "r50":
        module, variables = jax_models.load_fb_model(image_size=(32, 32), dtype="float32")
    else:
        module, variables = jax_models.load_ft_model(kind, num_classes=nc, clip_shape=clip,
                                                     dtype="float32")
    method = {"largei3d": "extract_features", "i3d": "trunk"}.get(kind)
    kw = {"method": method} if method else {"train": False}
    return variables, jax.jit(functools.partial(module.apply, **kw))


def _port_forward(kind: str, model, x: np.ndarray) -> tuple:
    with torch.inference_mode():
        if kind in ("unet++", "r50"):
            out = model(_nchw(x))
            return (out.permute(0, 2, 3, 1) if kind == "unet++" else out,)
        out = getattr(model, {"largei3d": "extract_features", "i3d": "trunk"}.get(kind, "forward"))(
            _ncdhw(x))
        return (out.permute(0, 2, 3, 4, 1),) if kind == "i3d" else out if isinstance(out, tuple) else (out,)


def _port_model(kind: str, path: str):
    nc, clip = KINDS[kind]
    if kind == "unet++":
        return load_fa_model(saved_model_file=path, dtype="float32", device="cpu")
    if kind == "r50":
        return load_fb_model(saved_model_file=path, dtype="float32", device="cpu")
    return load_ft_model(kind, saved_model_file=path, num_classes=nc, clip_shape=clip,
                         dtype="float32", device="cpu")


_PAYLOAD_KEY = {"unet++": "fa_model_state_dict", "r50": "fb_model_state_dict"}


@pytest.mark.parametrize("kind", list(KINDS))
def test_converted_files_cross_load_with_equal_forwards(kind, run_dir):
    """The port's ``convert_weights`` file restored by the JAX package's loader
    (``restore_like``, what its ``load_*_model(saved_model_file=)`` does) and the JAX
    converter's file (its CLI's two calls) loaded by the port's ``load_*_model``, the
    same forwards from each."""
    nc, clip = KINDS[kind]
    port_file = _convert_file(run_dir, kind, seed_sd(kind), nc)
    jax_file = str(run_dir / f"{kind}_jax.ckpt")
    jax_checkpoint.save_checkpoint(jax_file, jax_payload(kind, nc))
    template, apply = jax_model(kind)
    key = _PAYLOAD_KEY.get(kind, "ft_model_state_dict")
    shape = (1, *clip, 3) if clip else (1, 32, 32, 3)
    for seed, path in enumerate((port_file, jax_file)):
        variables = jax_checkpoint.restore_like(template, jax_checkpoint.load_checkpoint(path)[key])
        x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
        ref = apply(variables, jnp.asarray(x))
        ref = ref if isinstance(ref, tuple) else (ref,)
        ours = _port_forward(kind, _port_model(kind, path), x)
        assert len(ours) == len(ref)
        for o, r in zip(ours, ref):
            assert_close(o.float().numpy(), np.asarray(r))


def test_load_torch_checkpoint_wrappers_npz_and_refusals(tmp_path):
    sd = {"conv1.weight": torch.randn(4, 3, 3, 3), "bn1.running_mean": torch.zeros(4)}
    cases = {"bare": sd, **{k: {k: sd, "epoch": 3} for k in (
        "state_dict", "model_state_dict", "fa_model_state_dict", "ft_model_state_dict",
        "fb_model_state_dict")}}
    for name, obj in cases.items():
        path = str(tmp_path / f"{name}.pth")
        torch.save(obj, path)
        for loaded in (tc.load_torch_checkpoint(path), jax_tc.load_torch_checkpoint(path)):
            assert loaded.keys() == sd.keys()
            assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    npz = str(tmp_path / "seed.npz")
    np.savez(npz, **{k: v.numpy() for k, v in sd.items()})
    loaded = tc.load_torch_checkpoint(npz)
    assert loaded.keys() == sd.keys() and np.array_equal(loaded["conv1.weight"], sd["conv1.weight"].numpy())
    torch.save({"epoch": 3, "weights": {"a": torch.zeros(1)}}, str(tmp_path / "odd.pth"))
    with pytest.raises(ValueError, match="unrecognized checkpoint structure"):
        tc.load_torch_checkpoint(str(tmp_path / "odd.pth"))
    torch.save(torch.nn.Linear(2, 2), str(tmp_path / "module.pth"))  # a pickled module, not weights
    with pytest.raises(ValueError, match="not a weights-only"):
        tc.load_torch_checkpoint(str(tmp_path / "module.pth"))
    with pytest.raises(ValueError, match="unknown seed kind"):
        tc.convert_seed_payload("resnet152", sd, device="cpu")


def _keys_shapes(sd: dict) -> dict:
    return {k: tuple(v.shape) for k, v in sd.items()}


def test_dry_run_seeds_have_the_oracles_keys_and_shapes(run_dir):
    paths = write_dry_run_seeds(str(run_dir), seed=0)
    assert {k: p.rsplit("/", 1)[-1] for k, p in paths.items()} == SEED_FILES
    for kind, path in paths.items():
        assert _keys_shapes(torch.load(path, weights_only=True)) == _keys_shapes(oracle(kind).state_dict())
    assert _keys_shapes(reference_state_dict("r3d_18")) == _keys_shapes(oracle("r3d_18").state_dict())
    torch.manual_seed(0)  # the full-width mvit_v2_s layout: 16 blocks, 16x224^2 rel-pos tables
    full = _torch_mvitv2(depths=(1, 2, 11, 2), dims=(96, 192, 384, 768), heads=(1, 2, 4, 8),
                         kv_strides=((1, 8, 8), (1, 4, 4), (1, 2, 2), (1, 1, 1)),
                         input_thw=(8, 56, 56), num_classes=400)
    assert _keys_shapes(reference_state_dict("mvitv2")) == _keys_shapes(full.state_dict())
