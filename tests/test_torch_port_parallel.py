"""The port's data-parallel layer in one process (counterparts of tests/test_parallel.py's
mesh helpers and initialize_distributed rules): row layouts, padding, the start-up
rules, the one-process paths that must issue no collective and create no group, the
stages' "mesh disabled" rule, and a group of one (what ``--mesh`` joins without a
launcher) whose sharded step is the one-process step. The two-rank runs are in
test_torch_port_multiprocess.py and test_torch_port_dp_adversarial.py."""

from __future__ import annotations

import copy
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ted_spad_tpu_torch.ops.augment import AugmentParams
from ted_spad_tpu_torch.parallel import data_parallel_mesh, multihost, pad_to_multiple
from ted_spad_tpu_torch.parallel.mesh import DataParallelMesh

torch.set_num_threads(1)

COLLECTIVES = ("init_process_group", "new_group", "all_reduce", "all_gather", "broadcast",
               "barrier", "all_gather_object")


def fake(rank: int, world: int = 2) -> DataParallelMesh:
    """A mesh object for the row arithmetic alone (no group behind it)."""
    return DataParallelMesh(world, rank, torch.device("cpu"), "gloo")


@pytest.fixture()
def no_collectives(monkeypatch):
    """Every collective and group constructor raises: a path that runs under this
    issues none."""
    def refuse(*a, **k):
        raise AssertionError("a one-process path issued a collective")

    for name in COLLECTIVES:
        monkeypatch.setattr(dist, name, refuse)
    assert not dist.is_initialized()


class TestRows:
    def test_pad_to_multiple(self):
        batch = np.arange(10, dtype=np.float32).reshape(10, 1)
        padded, mask = pad_to_multiple(batch, 8)
        assert padded.shape == (16, 1)
        assert mask.sum() == 10 and not mask[10:].any()
        assert (padded[10:] == batch[-1]).all()
        same, full = pad_to_multiple(batch, 5)
        assert same is batch and full.all()

    def test_shard_rows_is_p_data_block(self):
        """Rank r of W holds rows [r n / W, (r + 1) n / W), as P('data') places them;
        the blocks tile the batch; a batch W does not divide is refused."""
        assert [fake(r).shard_rows(8) for r in range(2)] == [slice(0, 4), slice(4, 8)]
        blocks = np.concatenate([fake(r, 4).row_index(12) for r in range(4)])
        np.testing.assert_array_equal(blocks, np.arange(12))
        assert not fake(0).divides(7) and not fake(0).divides(0)
        with pytest.raises(ValueError, match="does not shard"):
            fake(0).row_index(7)

    def test_microbatch_layout(self):
        """With ``parts`` microbatches a rank holds its block of each global microbatch:
        microbatch i is still rows [i n / parts, (i + 1) n / parts) of the global batch,
        as the JAX package's reshape((n, B // n) + ...) defines it."""
        np.testing.assert_array_equal(fake(0).row_index(8, parts=2), [0, 1, 4, 5])
        np.testing.assert_array_equal(fake(1).row_index(8, parts=2), [2, 3, 6, 7])
        local = fake(1).take_rows(np.arange(8), parts=2)
        np.testing.assert_array_equal(local.reshape(2, -1), [[2, 3], [6, 7]])

    def test_take_rows_of_items_and_dataclasses(self):
        """A clip's V views (or frames) are consecutive rows: taking items takes their
        rows; a dataclass of arrays (an augmentation draw) is taken field by field;
        tensors too. ``_assemble`` puts the ranks' pieces back in global order."""
        rng = np.random.default_rng(0)
        n, v = 4, 3
        draw = AugmentParams(**{f: rng.random((n * v, 2) if f.startswith("erase") else n * v)
                                for f in AugmentParams.__dataclass_fields__})
        for parts in (1, 2):
            pieces = [fake(r).take_rows(draw, n, parts) for r in range(2)]
            for r, piece in enumerate(pieces):
                rows = (fake(r).row_index(n, parts)[:, None] * v + np.arange(v)).reshape(-1)
                np.testing.assert_array_equal(piece.y0, draw.y0[rows])
                np.testing.assert_array_equal(piece.erase_y, draw.erase_y[rows])
            back = fake(0)._assemble(pieces, n, parts)
            for f in AugmentParams.__dataclass_fields__:
                np.testing.assert_array_equal(getattr(back, f), getattr(draw, f))
        t = torch.arange(12).reshape(6, 2)
        assert torch.equal(fake(1).take_rows(t), t[3:])


class TestInitializeDistributed:
    """initialize_distributed swallows only the known single-process case; a cluster
    marker or explicit arguments make a failed start-up raise."""

    @staticmethod
    def _raiser(*a, **k):
        raise RuntimeError("rendezvous unreachable")

    def test_single_process_failure_swallowed(self, monkeypatch):
        monkeypatch.setattr(dist, "init_process_group", self._raiser)
        for marker in multihost.CLUSTER_MARKERS:
            monkeypatch.delenv(marker, raising=False)
        multihost.initialize_distributed()  # no-op, no raise
        assert not dist.is_initialized()
        assert multihost.process_shard() == (0, 1) and multihost.is_writer()
        assert multihost.local_batch_slice(8) == 8

    @pytest.mark.parametrize("marker", ["RANK", "WORLD_SIZE", "SLURM_JOB_NUM_NODES"])
    def test_cluster_marker_failure_raises(self, monkeypatch, marker):
        monkeypatch.setattr(dist, "init_process_group", self._raiser)
        monkeypatch.setenv(marker, "2")
        with pytest.raises(RuntimeError, match="rendezvous unreachable"):
            multihost.initialize_distributed()

    def test_explicit_args_failure_raises(self, monkeypatch):
        monkeypatch.setattr(dist, "init_process_group", self._raiser)
        for marker in multihost.CLUSTER_MARKERS:
            monkeypatch.delenv(marker, raising=False)
        with pytest.raises(RuntimeError, match="rendezvous unreachable"):
            multihost.initialize_distributed("tcp://10.0.0.1:1234", 2, 0)

    def test_group_of_one_refused_under_a_launcher(self, monkeypatch):
        """``--mesh`` without a launcher is a group of one; with torchrun's variables set
        it must not quietly become one."""
        monkeypatch.setenv("RANK", "1")
        with pytest.raises(RuntimeError, match="cluster marker"):
            multihost.initialize_single(backend="gloo")
        assert not dist.is_initialized()

    def test_default_backend_is_nccl_and_device_is_local_rank(self, monkeypatch):
        seen = {}
        monkeypatch.setattr(dist, "init_process_group", lambda backend, **k: seen.update(backend=backend))
        monkeypatch.setenv("LOCAL_RANK", "3")
        multihost.initialize_distributed()
        assert seen["backend"] == "nccl"
        assert multihost.local_device() == torch.device("cuda", 3)
        assert multihost.local_device("cpu") == torch.device("cpu")


def _mgfn(seed: int = 0):
    from ted_spad_tpu_torch.config.params import MGFNParams
    from ted_spad_tpu_torch.models import load_mgfn_model

    p = MGFNParams.for_dataset("UCF").replace(feature_size=16, dims=(8, 16), depths=(1, 1),
                                              mgfn_types=("gb", "fb"), dim_head=8, batch_size=2,
                                              dropout_rate=0.3)
    return p, load_mgfn_model(p, device="cpu").requires_grad_(True)


def _mgfn_batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    f = rng.random((4, 1, 32, 17)).astype(np.float32)
    return f[:2], np.zeros(2, np.float32), f[2:], np.ones(2, np.float32)


def _mgfn_step(p, model, mesh=None):
    from ted_spad_tpu_torch.stages.anomaly_detection import make_optimizer, make_train_step

    gen = torch.Generator().manual_seed(1)
    return make_train_step(model, make_optimizer(model, p), p, generator=gen, device="cpu", mesh=mesh)


def test_one_process_paths_issue_no_collective(no_collectives, tmp_path):
    """Without a mesh nothing touches torch.distributed: the MGFN step and scorer, the
    action step, the clip, VISPR and feature batches, checkpoints and metrics (every
    collective and group constructor raises here)."""
    from ted_spad_tpu_torch.config.params import ActionParams
    from ted_spad_tpu_torch.data import images
    from ted_spad_tpu_torch.data.videos import ClipDataset, synthetic_video_items
    from ted_spad_tpu_torch.models import load_ft_model
    from ted_spad_tpu_torch.stages import action_training
    from ted_spad_tpu_torch.stages.anomaly_detection import make_score_fn
    from ted_spad_tpu_torch.stages.common import make_optimizer
    from ted_spad_tpu_torch.utils.checkpoint import (
        BestCheckpointer, flush_checkpoints, load_checkpoint, save_checkpoint,
    )
    from ted_spad_tpu_torch.utils.logging import MetricsWriter

    p, model = _mgfn()
    assert np.isfinite(float(_mgfn_step(p, model)(*_mgfn_batch())))
    video = np.random.default_rng(1).random((2, 1, 16, 17)).astype(np.float32)
    assert make_score_fn(model, device="cpu")(video, np.ones((2, 16), bool)).shape == (2, 16)

    ap = ActionParams(num_classes=4, num_frames=8, reso_h=32, reso_w=32, compute_dtype="float32")
    ds = ClipDataset(synthetic_video_items(4, 4, num_frames=40, h=40, w=48), ap, num_workers=1)
    try:
        batch = next(ds.batches(2, seed=0))
    finally:
        ds.close()
    assert not batch.sharded
    ft = load_ft_model(tiny=True, num_classes=4, dtype="float32", device="cpu").requires_grad_(True)
    opt = make_optimizer(ft.parameters(), ap.opt_type, ap.learning_rate, ap.weight_decay)
    step = action_training.make_train_step(ft, opt, ap, generator=torch.Generator(), device="cpu")
    assert np.isfinite(float(step(batch.clips, batch.labels, batch.params, sharded=batch.sharded)))
    src = images.SyntheticImageSource(n=4, canonical=40)
    assert next(images.vispr_batches(src, 2, ssl=True, out_h=32, out_w=32)).images.shape[0] == 2

    path = save_checkpoint(str(tmp_path / "a.ckpt"), {"x": np.ones(3, np.float32)})
    BestCheckpointer(str(tmp_path), "m").maybe_save(1.0, 1, {"x": np.zeros(2, np.float32)})
    flush_checkpoints()
    assert load_checkpoint(path)["x"].tolist() == [1.0, 1.0, 1.0]
    assert os.path.exists(tmp_path / "m_1_best_1.0000.ckpt")
    writer = MetricsWriter(str(tmp_path), "run")
    writer.scalars({"loss": 1.0}, 1)
    writer.close()
    assert os.path.exists(tmp_path / "run" / "metrics.jsonl")


def test_mgfn_mesh_disabled_when_the_batch_does_not_shard(no_collectives, tmp_path):
    """train_anomaly_detection with a 2-rank mesh and batch_size 3 logs the JAX
    package's "mesh disabled" line and trains as one process (no collective)."""
    from ted_spad_tpu_torch.config.params import MGFNParams
    from ted_spad_tpu_torch.data import features
    from ted_spad_tpu_torch.stages.anomaly_detection import train_anomaly_detection
    from ted_spad_tpu_torch.train_mgfn import write_synthetic_features

    train, test, gt = write_synthetic_features(str(tmp_path), n_train=12, n_test=2, feature_size=16,
                                               clips=(40, 60), frames_per_clip=16, seed=0)
    p = MGFNParams.for_dataset("UCF").replace(
        rgb_list=train, test_rgb_list=test, feature_size=16, dims=(8, 16), depths=(1, 1),
        mgfn_types=("gb", "fb"), dim_head=8, batch_size=3, model_name="m")
    logs = []
    saved = features.ABNORMAL_SPLIT["UCF"]
    features.ABNORMAL_SPLIT["UCF"] = 6
    try:
        res = train_anomaly_detection(p, save_dir=str(tmp_path / "ckpt"), gt=gt, max_epochs=1,
                                      log_fn=logs.append, device="cpu", mesh=fake(0))
    finally:
        features.ABNORMAL_SPLIT["UCF"] = saved
    assert logs[0] == "mesh disabled: batch_size 3 not divisible by 2 devices"
    assert np.isfinite(res["history"]["loss"]).all() and os.path.exists(res["final_path"])


def test_group_of_one_is_the_one_process_step(tmp_path):
    """A gloo group of one on the CPU (the ``--mesh`` start-up without a launcher):
    the MGFN step with the mesh (global statistics through the all-reduce, the global
    dropout mask, the gathered outputs) equals the one-process step to float32
    rounding (rel 1e-6 per tensor); the ``train_mgfn --mesh`` CLI then runs in the same
    group and writes its checkpoints."""
    from ted_spad_tpu_torch import train_mgfn

    for marker in multihost.CLUSTER_MARKERS:
        assert not os.environ.get(marker)
    try:
        multihost.initialize_single(backend="gloo", timeout_s=60)
        mesh = data_parallel_mesh("cpu")
        assert (mesh.world_size, mesh.rank, mesh.backend) == (1, 0, "gloo")
        p, model = _mgfn()
        twin = copy.deepcopy(model)
        losses = [float(_mgfn_step(p, m, mesh)(*_mgfn_batch())) for m, mesh in ((model, mesh), (twin, None))]
        assert losses[0] == pytest.approx(losses[1], rel=1e-6)
        for (k, a), b in zip(model.state_dict().items(), twin.state_dict().values()):
            assert torch.allclose(a.float(), b.float(), rtol=1e-6, atol=1e-7), k
        args = train_mgfn.parser().parse_args(["--synthetic", "--device", "cpu", "--epochs", "1",
                                               "--mesh", "--backend", "gloo",
                                               "--save_dir", str(tmp_path)])
        res = train_mgfn.run(args)
        assert os.path.exists(res["final_path"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        multihost.set_host_group(None)
