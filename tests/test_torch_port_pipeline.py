"""The port's workflow modules against the JAX package's, on the CPU: the
``style="attrs"`` synthetic images and the synthetic UCF-Crime fixture (bit-equal),
``model_size_report`` (string-equal), ``profile_trace``, and the chained CLIs
``run_pipeline``, ``validate_adversarial --scale tiny`` and ``run_parity --dry-run
--tiny`` end to end with ``--device cpu``: finite summaries, each checkpoint a stage
writes read by the stage after it, the report's keys JAX's, ``ABNORMAL_SPLIT``
restored, and the refusals with JAX's messages; and each chain's calls against the JAX
script's, ``run_parity``'s real-data branch included (miniature UCF101, VISPR and
UCF-Crime inputs written under tmp_path). torch on one thread."""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import ted_spad_tpu_torch.config.params as port_params
import ted_spad_tpu_torch.data.features as port_features
import ted_spad_tpu_torch.utils.checkpoint as port_checkpoint
from ted_spad_tpu import models as jax_models
from ted_spad_tpu.data.images import SyntheticImageSource as JaxSyntheticImageSource
from ted_spad_tpu.utils.model_size import model_size_report as jax_model_size_report
from ted_spad_tpu_torch import (
    convert_weights, profile_stage, run_parity, run_pipeline, validate_adversarial,
)
from ted_spad_tpu_torch.data import video_reader as port_video_reader
from ted_spad_tpu_torch.data.images import SyntheticImageSource
from ted_spad_tpu_torch.data.videos import synthetic_crime_fixture
from ted_spad_tpu_torch.models import load_fa_model, load_ft_model
from ted_spad_tpu_torch.utils.logging import profile_trace
from ted_spad_tpu_torch.utils import reference_layout
from ted_spad_tpu_torch.utils.model_size import model_size_report, param_count, tree_bytes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts._common import synthetic_crime_fixture as jax_crime_fixture  # noqa: E402


@pytest.mark.parametrize("n,num_pa,seed,canonical", [(12, 7, 0, 64), (5, 3, 4, 256), (9, 9, 1, 50)])
def test_attrs_images_equal_jax(n, num_pa, seed, canonical):
    for style in ("attrs", "stripes"):
        ours = SyntheticImageSource(n, num_pa, seed, canonical, style=style)
        ref = JaxSyntheticImageSource(n, num_pa, seed, canonical, style=style)
        idx = list(range(n)) + [n + 1, 2 * n - 1]  # indices wrap around n
        (img, lab), (rimg, rlab) = ours.get_batch(idx), ref.get_batch(idx)
        assert img.dtype == rimg.dtype == np.uint8 and np.array_equal(img, rimg)
        assert lab.dtype == rlab.dtype and np.array_equal(lab, rlab)


@pytest.mark.parametrize("kw", [{}, {"n_abnormal": 2, "n_normal": 2},
                                {"n_abnormal": 1, "n_normal": 3, "num_frames": 64, "h": 40,
                                 "w": 80, "clip_span": 31, "clip_step": 32}])
def test_crime_fixture_equals_jax(kw):
    uris, gt, split = synthetic_crime_fixture(**kw)
    ruris, rgt, rsplit = jax_crime_fixture(**kw)
    assert uris == ruris and split == rsplit
    assert gt.dtype == rgt.dtype and np.array_equal(gt, rgt)


def test_model_size_report_equals_jax():
    fa = load_fa_model(dtype="float32", device="cpu")
    _, jfa = jax_models.load_fa_model(image_size=(32, 32), dtype="float32")
    assert model_size_report(fa, "fa") == jax_model_size_report(jfa, "fa")
    ft = load_ft_model(tiny=True, num_classes=5, dtype="float32", device="cpu")
    _, jft = jax_models.load_ft_model("largei3d", num_classes=5, clip_shape=(8, 32, 32),
                                      dtype="float32", tiny=True)
    assert model_size_report(ft, "ft") == jax_model_size_report(jft, "ft")
    # BN running statistics are state; num_batches_tracked is not in the tree at all.
    n_bn = sum(m.running_mean.numel() * 2 for m in fa.modules()
               if isinstance(m, torch.nn.modules.batchnorm._BatchNorm))
    assert param_count(fa) == sum(q.numel() for q in fa.parameters())
    assert tree_bytes(fa) == 4 * (param_count(fa) + n_bn)


def test_profile_trace_names_an_aten_op_and_writes_nothing_when_disabled(tmp_path):
    x = torch.randn(8, 8)
    with profile_trace(str(tmp_path / "off"), enabled=False):
        x @ x
    assert not (tmp_path / "off").exists()
    with profile_trace(str(tmp_path / "on")):
        x @ x
    (trace,) = list((tmp_path / "on").iterdir())
    assert trace.name.endswith(".pt.trace.json")
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert "aten::mm" in names


@pytest.mark.parametrize("cli", [convert_weights, profile_stage, run_pipeline,
                                 validate_adversarial, run_parity])
def test_cli_help_parses(cli, capsys):
    with pytest.raises(SystemExit) as e:
        cli.parser().parse_args(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


def test_profile_stage_refuses_the_anonymizer_with_jax_message():
    args = profile_stage.parser().parse_args(["--stage", "anonymizer", "--device", "cpu"])
    with pytest.raises(SystemExit, match="anonymizer profiling: run scripts/train_anonymizer.py "
                                         "under profile_trace"):
        profile_stage.run(args)


@pytest.fixture()
def run_dir(tmp_path):
    """``tmp_path``, emptied when the test ends: these runs write full-width checkpoints
    (hundreds of MB to GBs), which pytest would otherwise keep for three sessions."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture()
def reads(monkeypatch):
    """Every checkpoint path the port's loaders read, in order."""
    seen: list[str] = []
    real = port_checkpoint.load_checkpoint

    def load(path):
        seen.append(os.path.abspath(path))
        return real(path)

    monkeypatch.setattr(port_checkpoint, "load_checkpoint", load)
    return seen


def _finite(history: dict) -> bool:
    return all(np.isfinite(v).all() for v in history.values() if len(v))


def test_run_pipeline_chains_the_five_stages_on_cpu(run_dir, reads):
    args = run_pipeline.parser().parse_args(["--synthetic", "--device", "cpu", "--save_dir",
                                             str(run_dir)])
    split = port_features.ABNORMAL_SPLIT["UCF"]
    res = run_pipeline.run(args)
    assert port_features.ABNORMAL_SPLIT["UCF"] == split
    rec, anon, feats, mg, priv = (res[k] for k in ("recon", "anon", "features", "mgfn", "privacy"))
    assert rec["best_path"] and os.path.abspath(rec["best_path"]) in reads  # stage 1 -> 2
    assert _finite(rec["history"]) and _finite(anon["history"]) and _finite(priv["history"])
    uris, _, _ = synthetic_crime_fixture(3, 3)
    assert sorted(feats["saved"]) == sorted(uris) and feats["clips"] == 36
    listed = open(run_dir / "pipe_train.list").read().split()
    assert listed == [feats["saved"][u] for u in uris]  # stage 3 -> 4, in gt order
    assert all(np.load(p).shape == (6, 2048) and np.isfinite(np.load(p)).all() for p in listed)
    assert len(mg["history"]["test_AUC"]) == 2 and 0.0 <= max(mg["history"]["test_AUC"]) <= 1.0
    assert 0.0 <= priv["best_cmap"] <= 1.0


def test_validate_adversarial_tiny_on_cpu(run_dir):
    args = validate_adversarial.parser().parse_args(
        ["--scale", "tiny", "--epochs", "1", "--attack_epochs", "1", "--device", "cpu",
         "--save_dir", str(run_dir)])
    res = validate_adversarial.run(args)
    assert _finite(res["anon"]["history"])
    for k in ("raw", "anonymized"):
        assert 0.0 <= res[k]["best_cmap"] <= 1.0 and _finite(res[k]["history"])
    assert res["delta"] == pytest.approx(res["raw"]["best_cmap"] - res["anonymized"]["best_cmap"])
    assert set(res["seconds"]) == {"anon", "privacy_raw", "privacy_anon"}
    assert res["anon"]["remat"] is False  # "auto" at 32^2: far below REMAT_AUTO_PIXELS


def _jax_report_keys() -> set[str]:
    """The keys of the report dict scripts/run_parity.py writes, read from its source."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", "run_parity.py")).read())
    (node,) = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and any(getattr(t, "id", None) == "report" for t in n.targets)]
    return {k.value for k in node.keys}


def test_run_parity_dry_run_tiny_on_cpu(run_dir, reads):
    split = port_features.ABNORMAL_SPLIT["UCF"]
    res = run_parity.main(["--dry-run", "--tiny", "--device", "cpu", "--num_workers", "2",
                           "--save_dir", str(run_dir)])
    assert port_features.ABNORMAL_SPLIT["UCF"] == split
    report = json.load(open(run_dir / "parity_report.json"))
    assert set(report) == _jax_report_keys()
    assert {k: v for k, v in res.items() if k not in ("stage_seconds", "sizes")} == report
    assert res["sizes"]["extract_clips"] == {"raw": 24, "anon": 24}  # 4 videos x 6 clips
    assert report["seeds_converted"] == ["fa", "fb", "ft"]
    assert all(np.isfinite(report[k]) for k in report if isinstance(report[k], float))
    seeds = run_dir / "seeds"
    assert str(seeds / "ft_largei3d_seed.ckpt") in reads  # the converted seed -> action training
    assert any("parity_action" in r for r in reads)  # action's checkpoint -> the anonymizer's ft
    assert any("parity_recon" in r for r in reads)  # the reconstruction's -> the anonymizer's fa
    assert set(res["stage_seconds"]) >= {"seeds", "action", "recon", "anon", "extract_anon",
                                         "mgfn_anon"}


def test_run_parity_real_mode_refuses_missing_arguments_with_jax_message():
    jax_run = subprocess.run([sys.executable, "scripts/run_parity.py", "--cpu",
                              "--vispr_train", "v"], cwd=ROOT, capture_output=True, text=True,
                             timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert jax_run.returncode == 1
    with pytest.raises(SystemExit) as e:
        run_parity.main(["--device", "cpu", "--vispr_train", "v"])
    assert str(e.value) == jax_run.stderr.strip().splitlines()[-1]
    assert str(e.value).startswith("real-data mode needs --ucf101_train_list --ucf101_val_list")


def test_run_parity_refuses_misaligned_features(tmp_path):
    for i in range(2):
        np.save(tmp_path / f"v{i}.npy", np.zeros((3, 8), np.float32))
    feats = {"saved": {"a": str(tmp_path / "v0.npy")}, "existing": {"b": str(tmp_path / "v1.npy")}}
    lst, tlst = run_parity.mgfn_lists("raw", feats, ["a", "b"], ["a", "b"], ["b"],
                                      np.zeros(3 * 32), str(tmp_path))
    assert open(lst).read().split() == [feats["saved"]["a"], feats["existing"]["b"]]
    assert open(tlst).read().split() == [feats["existing"]["b"]]
    with pytest.raises(RuntimeError, match="have no features"):
        run_parity.mgfn_lists("raw", feats, ["a", "b", "c"], ["a", "b"], ["b"], np.zeros(96),
                              str(tmp_path))
    with pytest.raises(RuntimeError, match="gt has 95 frames but the test features cover 3 clips"):
        run_parity.mgfn_lists("anon", feats, ["a", "b"], ["a", "b"], ["b"], np.zeros(95),
                              str(tmp_path))


# ---- the chains' arguments against the JAX scripts' ---------------------------------
# Each stage is replaced, in both packages, by a stub that records what it is given and
# returns a minimal summary. The synthetic results cannot match across the two
# packages' random generators, but what each stage is handed can: its Params, epochs,
# sizes and data, and which file of the stage before it it reads.

_PORT_PARAMS = {c.__name__: c for c in vars(port_params).values()
                if isinstance(c, type) and dataclasses.is_dataclass(c)}


class _Handle:
    """A trained model as a stage summary hands it on (the port's module, the JAX
    package's variables), named by its stage and slot."""

    def __init__(self, name: str):
        self.name = name

    def to(self, *args, **kwargs) -> "_Handle":
        return self


def _norm(v, save: str):
    """``v`` as plain data: paths under ``save`` relative to it, Params as their fields
    (a JAX-only field must hold its default and is dropped), data sources as their
    length and a digest of their first and last items, arrays as a digest."""
    if isinstance(v, _Handle):
        return f"<{v.name}>"
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        fields = {f.name: getattr(v, f.name) for f in dataclasses.fields(v)}
        port_cls = _PORT_PARAMS.get(type(v).__name__)
        if port_cls is not None:
            default = type(v)()
            for k in set(fields) - {f.name for f in dataclasses.fields(port_cls)}:
                assert fields.pop(k) == getattr(default, k), f"{type(v).__name__}.{k} set"
        return [type(v).__name__, _norm(fields, save)]
    if isinstance(v, str):
        return "<save>/" + os.path.relpath(v, save) if v.startswith(save) else v
    if isinstance(v, (list, tuple)):
        return [_norm(x, save) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x, save) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return ["array", v.dtype.str, list(v.shape), hashlib.sha1(v.tobytes()).hexdigest()]
    if hasattr(v, "get_batch"):
        images, labels = v.get_batch([0, len(v) - 1])
        return [type(v).__name__, len(v), _norm(np.asarray(images), save),
                _norm(np.asarray(labels), save)]
    if v is None or isinstance(v, (bool, int, float)):
        return v
    raise TypeError(f"no plain form for {type(v)}")


def _stub_stages(monkeypatch, jax: bool, save: str) -> list:
    """Replace the stages (and the seed conversion's file work) of one package by
    recorders; returns the list they append to, in call order."""
    import ted_spad_tpu.data.features as jax_features
    import ted_spad_tpu.stages.action_training as j_action
    import ted_spad_tpu.stages.anomaly_detection as j_anomaly
    import ted_spad_tpu.stages.anonymization_training as j_anon
    import ted_spad_tpu.stages.fa_pretraining as j_recon
    import ted_spad_tpu.stages.feature_extraction as j_extract
    import ted_spad_tpu.stages.privacy_training as j_privacy
    import ted_spad_tpu.utils.checkpoint as j_checkpoint
    import ted_spad_tpu.utils.torch_convert as j_convert
    import ted_spad_tpu_torch.stages.action_training as p_action
    import ted_spad_tpu_torch.stages.anomaly_detection as p_anomaly
    import ted_spad_tpu_torch.stages.anonymization_training as p_anon
    import ted_spad_tpu_torch.stages.fa_pretraining as p_recon
    import ted_spad_tpu_torch.stages.feature_extraction as p_extract
    import ted_spad_tpu_torch.stages.privacy_training as p_privacy
    import ted_spad_tpu_torch.utils.torch_convert as p_convert

    calls: list = []
    rename = {"fa_variables": "fa", "ft_variables": "ft", "fa_model": "fa"}

    def record(stage, args, kw):
        kw = {rename.get(k, k): x for k, x in kw.items() if k not in ("device", "log_fn", "mesh")}
        calls.append([stage, _norm(list(args), save), _norm(kw, save)])

    def train_action(p, **kw):
        record("action", [p], kw)
        return {"history": {"val_acc": [0.5]}, "best_acc": 0.5,
                "best_path": os.path.join(kw["save_dir"], p.run_id, "model_best.ckpt")}

    def train_reconstruction(p, **kw):
        record("recon", [p], kw)
        return {"history": {"val_loss": [0.1]},
                "best_path": os.path.join(kw["save_dir"], p.run_id, "model_best.ckpt")}

    def train_anonymizer(p, **kw):
        record("anon", [p], kw)
        models = {slot: _Handle(f"{p.run_id}.{slot}") for slot in ("fa", "fb", "ft")}
        if jax:
            models = {f"{slot}_variables": m for slot, m in models.items()}
        return {"history": {"val_acc": [0.5]}, "best_acc": 0.5, "best_path": None, **models}

    def train_privacy(p, **kw):
        record("privacy", [p], kw)
        return {"history": {"val_cmap": [0.5]}, "best_cmap": 0.5, "best_path": None}

    def extract_features(p, uris, out_dir, **kw):
        record("extract", [p, uris, out_dir], kw)
        os.makedirs(out_dir, exist_ok=True)
        saved, clips = {}, 0
        for i, uri in enumerate(uris):
            n = (int(uri.split("n=")[1].split(",")[0]) if uri.startswith("synthetic://")
                 else len(port_video_reader.VideoReader(uri)))
            rows = len(p_extract.video_clip_starts(n, p.num_frames, p.clip_stride, p.clip_step))
            saved[uri] = os.path.join(out_dir, f"{i}.npy")
            np.save(saved[uri], np.zeros((rows, 2), np.float32))
            clips += rows
        return {"saved": saved, "existing": {}, "skipped": {}, "clips": clips,
                "elapsed_s": 1.0, "clips_per_sec": float(clips)}

    def train_anomaly_detection(p, **kw):
        record("mgfn", [p], kw)
        features = jax_features if jax else port_features
        calls.append(["mgfn lists", *[_norm(open(f).read().split(), save)
                                      for f in (p.rgb_list, p.test_rgb_list)],
                      features.ABNORMAL_SPLIT["UCF"]])
        return {"history": {"test_AUC": [0.5, 0.6]}}

    def load_torch_checkpoint(path):
        return {"file": os.path.basename(path)}

    def convert_seed_payload(kind, sd, **kw):
        calls.append(["convert", kind, sd["file"], kw["num_classes"], list(kw["clip_shape"])])
        return {"kind": kind}

    def save_checkpoint(path, payload):
        calls.append(["save seed", _norm(path, save), payload])
        return path

    stages = (j_action, j_recon, j_anon, j_privacy, j_extract, j_anomaly) if jax else (
        p_action, p_recon, p_anon, p_privacy, p_extract, p_anomaly)
    for module, fn in zip(stages, (train_action, train_reconstruction, train_anonymizer,
                                   train_privacy, extract_features, train_anomaly_detection)):
        monkeypatch.setattr(module, fn.__name__, fn)
    convert = j_convert if jax else p_convert
    monkeypatch.setattr(convert, "load_torch_checkpoint", load_torch_checkpoint)
    monkeypatch.setattr(convert, "convert_seed_payload", convert_seed_payload)
    monkeypatch.setattr(j_checkpoint if jax else port_checkpoint, "save_checkpoint", save_checkpoint)

    def seed_files(out_dir, seed=0):
        return {kind: os.path.join(out_dir, name) for kind, name in reference_layout.SEED_FILES.items()}

    if jax:
        import scripts._common
        import scripts.run_parity

        monkeypatch.setattr(scripts._common, "setup_platform", lambda args: None)
        monkeypatch.setattr(scripts.run_parity, "_oracle_state_dicts", seed_files)
    else:
        monkeypatch.setattr(reference_layout, "write_dry_run_seeds", seed_files)
    return calls


def _run_jax_script(monkeypatch, name: str, argv: list[str]) -> None:
    import importlib

    module = importlib.import_module(f"scripts.{name}")
    if hasattr(module, "setup_platform"):
        monkeypatch.setattr(module, "setup_platform", lambda args: None)
    monkeypatch.setattr(sys, "argv", [f"scripts/{name}.py", *argv])
    module.main()


def _both(monkeypatch, tmp_path, name, jax_argv, port_run) -> tuple[list, list]:
    """The recorded calls of JAX's script and of the port's CLI, each in a save
    directory of its own."""
    out = []
    for jax in (True, False):
        save = str(tmp_path / ("jax" if jax else "port"))
        with monkeypatch.context() as m:
            calls = _stub_stages(m, jax, save)
            split = port_features.ABNORMAL_SPLIT["UCF"]
            if jax:
                import ted_spad_tpu.data.features as jax_features

                split = jax_features.ABNORMAL_SPLIT["UCF"]
                try:
                    _run_jax_script(m, name, [*jax_argv, "--save_dir", save])
                finally:  # run_pipeline.py leaves its split set
                    jax_features.ABNORMAL_SPLIT["UCF"] = split
            else:
                port_run(["--device", "cpu", "--save_dir", save])
                assert port_features.ABNORMAL_SPLIT["UCF"] == split
        out.append(calls)
    return out[0], out[1]


_OVERLAYS = {"action": "weight_decay = 0.0123\n", "recon": 'arch_fa = "unet"\nlearning_rate = 0.0042\n',
             "anon": 'arch_fa = "unet"\nnum_epochs = 7\n', "privacy": 'arch_fa = "unet"\n',
             "extract": 'arch_fa = "unet"\nbatch_size = 12\n'}


@pytest.mark.parametrize("tiny,overlay", [(True, False), (True, True), (False, True)])
def test_run_parity_hands_each_stage_what_jax_does(monkeypatch, tmp_path, tiny, overlay):
    argv = ["--dry-run"] + (["--tiny"] if tiny else [])
    if overlay:
        for key, text in _OVERLAYS.items():
            path = tmp_path / "reference" / run_parity.REF_PARAMS[key]
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(text)
        argv += ["--params_dir", str(tmp_path / "reference")]
    monkeypatch.setattr(tempfile, "mkdtemp", lambda **kw: str(tmp_path / "jax seed sources"))
    jax_calls, port_calls = _both(monkeypatch, tmp_path, "run_parity", argv,
                                  lambda a: run_parity.main(argv + a))
    assert [c[0] for c in port_calls] == (
        ["convert", "save seed"] * 3 + ["action", "recon", "anon", "privacy", "privacy", "extract",
                                        "extract", "mgfn", "mgfn lists", "mgfn", "mgfn lists"])
    for ours, ref in zip(port_calls, jax_calls, strict=True):
        assert ours == ref
    anon = port_calls[8][1][0][1]
    assert anon["saved_model_fa"] == "<save>/parity_recon/model_best.ckpt"
    assert anon["saved_model_ft"] == "<save>/parity_action/model_best.ckpt"
    assert port_calls[10][2]["fa"] == port_calls[12][2]["fa"] == "<parity_anon.fa>"


def _real_data(root) -> dict:
    """Miniature real-data inputs of ``run_parity``: two-line UCF101 lists over tiny mp4s
    written with the port's encoder, VISPR jpgs with their labels pickles, UCF101 frame
    jpgs, seed files, UCF-Crime train and test trees whose normal directories
    (Testing_Normal_Videos_Anomaly, Training-Normal-Videos) a sorted glob puts between
    the crime categories, and a gt ``.npy`` for each choice of test videos (32 frames a
    clip of the extraction's defaults). Returns the CLI's arguments by name."""
    import pickle

    from PIL import Image

    rng = np.random.default_rng(5)

    def video(rel: str, frames: int) -> str:
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return port_video_reader.write_mp4(path, rng.integers(0, 256, (frames, 32, 32, 3), np.uint8))

    def jpgs(folder: str, names: list[str]) -> None:
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        for name in names:
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), np.uint8)).save(
                os.path.join(root, folder, f"{name}.jpg"))

    for rel in ("ApplyEyeMakeup/v_ApplyEyeMakeup_g01_c01.mp4", "Archery/v_Archery_g01_c01.mp4",
                "ApplyEyeMakeup/v_ApplyEyeMakeup_g08_c01.mp4", "Archery/v_Archery_g08_c02.mp4"):
        video(os.path.join("ucf101", "videos", rel), 8)
    for name, rels in (("trainlist01.txt", ["ApplyEyeMakeup/v_ApplyEyeMakeup_g08_c01.mp4 1",
                                            "Archery/v_Archery_g08_c02.mp4 2"]),
                       ("testlist01.txt", ["ApplyEyeMakeup/v_ApplyEyeMakeup_g01_c01.mp4",
                                           "Archery/v_Archery_g01_c01.mp4"])):
        (root / "ucf101" / name).write_text("\n".join(rels) + "\n")
    os.makedirs(root / "vispr_labels")
    for split, names in (("train", [f"2017_{i:08d}" for i in range(5)]),
                         ("test", [f"2017_{i:08d}" for i in range(10, 13)])):
        jpgs(f"vispr_{split}", names)
        with open(root / "vispr_labels" / f"{split}_labels.pkl", "wb") as f:
            pickle.dump({n: (rng.random(7) < 0.4).astype(np.float32) for n in names}, f)
    jpgs(os.path.join("ucf101_frames", "v_Archery_g01_c01"), ["f001", "f002"])
    os.makedirs(root / "seeds")
    for name in reference_layout.SEED_FILES.values():
        (root / "seeds" / name).write_bytes(b"seed")
    # 72 frames give two clips of 16 at stride 2, step 32; 40 frames one.
    clips = {}
    for rel, frames in (("Train/Abuse/Abuse001_x264.mp4", 72),
                        ("Train/Testing_Normal_Videos_Anomaly/Normal_Videos_001_x264.mp4", 40),
                        ("Train/Training-Normal-Videos/Normal_Videos_002_x264.mp4", 72),
                        ("Train/Vandalism/Vandalism001_x264.mp4", 40),
                        ("Test/Burglary/Burglary001_x264.mp4", 72),
                        ("Test/Testing_Normal_Videos_Anomaly/Normal_Videos_003_x264.mp4", 40)):
        clips[rel] = 2 if frames == 72 else 1
        video(os.path.join("crime", rel), frames)
    for name, n in (("gt-test.npy", sum(c for r, c in clips.items() if r.startswith("Test"))),
                    ("gt-train.npy", sum(c for r, c in clips.items() if r.startswith("Train")))):
        np.save(root / name, (rng.random(32 * n) < 0.3).astype(np.float32))
    return {"seeds_dir": root / "seeds", "ucf101_train_list": root / "ucf101" / "trainlist01.txt",
            "ucf101_val_list": root / "ucf101" / "testlist01.txt",
            "ucf101_videos": root / "ucf101" / "videos", "ucf101_frames": root / "ucf101_frames",
            "vispr_train": root / "vispr_train", "vispr_test": root / "vispr_test",
            "vispr_labels": root / "vispr_labels", "crime_glob": root / "crime" / "Train" / "*" / "*.mp4",
            "crime_test_glob": root / "crime" / "Test" / "*" / "*.mp4"}


@pytest.mark.parametrize("test_glob", [True, False])
def test_run_parity_real_data_hands_each_stage_what_jax_does(monkeypatch, tmp_path, test_glob):
    if not port_video_reader.native_available():
        pytest.skip("FFmpeg's libraries do not build here")
    inputs = _real_data(tmp_path / "data")
    if not test_glob:
        del inputs["crime_test_glob"]
    inputs["crime_gt"] = tmp_path / "data" / ("gt-test.npy" if test_glob else "gt-train.npy")
    argv = [x for k, v in inputs.items() for x in (f"--{k}", str(v))] + ["--num_workers", "2"]
    jax_calls, port_calls = _both(monkeypatch, tmp_path, "run_parity", argv,
                                  lambda a: run_parity.main(argv + a))
    assert [c[0] for c in port_calls] == (
        ["convert", "save seed"] * 3 + ["action", "recon", "anon", "privacy", "privacy", "extract",
                                        "extract", "mgfn", "mgfn lists", "mgfn", "mgfn lists"])
    for ours, ref in zip(port_calls, jax_calls, strict=True):
        assert ours == ref
    # Abnormal first, then the normal directories; the split counts the abnormal ones.
    crime = [os.path.relpath(u, tmp_path / "data" / "crime") for u in port_calls[11][1][1]]
    train = ["Train/Abuse/Abuse001_x264.mp4", "Train/Vandalism/Vandalism001_x264.mp4",
             "Train/Testing_Normal_Videos_Anomaly/Normal_Videos_001_x264.mp4",
             "Train/Training-Normal-Videos/Normal_Videos_002_x264.mp4"]
    test = ["Test/Burglary/Burglary001_x264.mp4",
            "Test/Testing_Normal_Videos_Anomaly/Normal_Videos_003_x264.mp4"] if test_glob else train
    assert crime == train + (test if test_glob else [])
    assert port_calls[14][3] == jax_calls[14][3] == 2
    orders = [open(tmp_path / side / "parity_crime_order.txt").read() for side in ("jax", "port")]
    assert orders[0] == orders[1] == "\n".join(str(tmp_path / "data" / "crime" / t) for t in test) + "\n"
    recon = port_calls[7][2]["train_source"]
    assert recon[:2] == ["ReconstructionSource", 7]  # five VISPR jpgs and two frames


@pytest.mark.parametrize("scale", ["tiny", "reference"])
def test_validate_adversarial_hands_each_stage_what_jax_does(monkeypatch, tmp_path, scale):
    argv = ["--scale", scale, "--epochs", "2", "--attack_epochs", "1"]
    jax_calls, port_calls = _both(
        monkeypatch, tmp_path, "validate_adversarial", argv,
        lambda a: validate_adversarial.run(validate_adversarial.parser().parse_args(argv + a)))
    assert [c[0] for c in port_calls] == (["recon"] if scale == "reference" else []) + [
        "anon", "privacy", "privacy"]
    for ours, ref in zip(port_calls, jax_calls, strict=True):
        assert ours == ref
    if scale == "reference":
        assert port_calls[1][1][0][1]["saved_model_fa"] == "<save>/validate_recon/model_temp.ckpt"


def test_run_pipeline_hands_each_stage_what_jax_does(monkeypatch, tmp_path):
    jax_calls, port_calls = _both(
        monkeypatch, tmp_path, "run_pipeline", ["--synthetic"],
        lambda a: run_pipeline.run(run_pipeline.parser().parse_args(["--synthetic", *a])))
    assert [c[0] for c in port_calls] == ["recon", "anon", "extract", "mgfn", "mgfn lists", "privacy"]
    for ours, ref in zip(port_calls, jax_calls, strict=True):
        assert ours == ref
    assert port_calls[1][1][0][1]["saved_model_fa"] == "<save>/pipe_recon/model_best.ckpt"
    assert port_calls[2][2]["fa"] == port_calls[5][2]["fa"] == "<pipe_anon.fa>"
