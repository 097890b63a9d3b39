"""Each traffic kind at tiny sizes on the port's plain paths (the CPU): a whole run,
with the reference holding the program's outputs."""

import itertools
import time

import numpy as np
import pytest
import torch

from bench_port.kinds import adv_train, extract
from bench_port.reference import models as ref
from bench_port.tests import tiny


@pytest.mark.parametrize("config", ["tedspad_unetpp_i3res50", "tedspad_unet_i3res50"])
def test_extract_run_is_correct(config):
    out = extract.run(cfg=tiny.config(config), traffic=tiny.traffic(), seed=2**31 + 7,
                      seconds=0.3, trace=False, t_start=time.perf_counter(), device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["e2e"]["clips_per_s"] > 0 and out["e2e"]["setup_s"] > 0
    # float32 program against the float32 reference: rounding only.
    assert out["checks"]["feat_err"][0] < 1e-3
    assert out["checks"]["score_err"][0] < 1e-5


def test_extract_window_packs_videos_in_order_and_scores_each():
    """Every video is extracted before any is scored, as ``score_video`` does."""
    cell = extract.ExtractCell(tiny.config("tedspad_unetpp_i3res50"), tiny.traffic(), 3,
                               torch.device("cpu"), time.perf_counter())
    cell.setup(build=False)
    calls = []
    step, score = cell.extract, cell.score
    cell.extract = lambda x: calls.append("step") or step(x)
    cell.score = lambda f: calls.append("score") or score(f)
    cell.window(0.3, False)
    assert calls == sorted(calls, key=lambda c: c == "score") and calls[-1] == "score"
    assert calls.count("score") == len(cell.started)
    assert cell.started == list(range(cell.started[0], cell.started[0] + len(cell.started)))
    for v in cell.started:
        assert len(cell.scores[v]) == len(cell.feats_of[v]) * cell.step
    assert cell.record["clips"] == sum(len(cell.feats_of[v]) for v in cell.started)


def test_extract_same_seed_same_inputs():
    def inputs(seed):
        cell = extract.ExtractCell(tiny.config("tedspad_unetpp_i3res50"), tiny.traffic(), seed,
                                   torch.device("cpu"), 0.0)
        cell.setup(build=False)
        return np.stack(cell.clip_pool), cell.videos, cell.weights["fa"]

    a, b, c = inputs(2**31 + 3), inputs(2**31 + 3), inputs(2**31 + 4)
    assert np.array_equal(a[0], b[0])
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])
    assert not np.array_equal(a[0], c[0])


def test_every_seed_draws_the_same_lengths_in_another_order():
    tr = tiny.traffic()
    cycle = tr["lengths_per_cycle"]
    first = [list(itertools.islice(extract.video_lengths(tr, seed), 3 * cycle))
             for seed in (1, 2**31 + 5)]
    for lengths in first:
        for k in range(3):
            assert sorted(lengths[k * cycle:(k + 1) * cycle]) == sorted(first[0][:cycle])
    assert first[0] != first[1]


def test_extract_traced_run_reads_its_trace():
    out = extract.run(cfg=tiny.config("tedspad_unetpp_i3res50"), traffic=tiny.traffic(), seed=5,
                      seconds=0.8, trace=True, t_start=time.perf_counter(), device="cpu")
    t = out["record"]["trace"]
    assert t["window_s"] > 0 and "device_ops" in out["breakdown"]


def test_adv_train_float32_program_follows_the_reference():
    """With the steps in float32 the program and the reference differ by rounding."""
    cfg = tiny.config("tedspad_unetpp_i3res50")
    cfg["anonymization"]["compute_dtype"] = "float32"
    out = adv_train.run(cfg=cfg, traffic=tiny.traffic("adv_train_ucf101"), seed=2**31 + 9,
                        seconds=0.5, trace=False, t_start=time.perf_counter(), device="cpu")
    c = out["checks"]
    assert out["record"]["diag"]["loss_err"] < 1e-4 and c["grad_err"][0] < 1e-2
    assert c["change_err"][0] < 2e-2 and c["stats_err"][0] < 1e-4
    assert out["record"]["calls"] % 2 == 0 and out["e2e"]["train_step_ms"] > 0


def test_reference_preprocess_matches_the_resample_definition():
    """The reference's crop + antialiased resize against a direct triangle filter."""
    x = torch.randint(0, 256, (1, 1, 12, 16, 3), dtype=torch.uint8)
    out = ref.preprocess(x, 6, 6, 0.8)  # window 9 x 12 at (2 rounded half-even, 2)
    assert out.shape == (1, 1, 3, 6, 6)
    y0, ch = ref.center_window(12, 0.8)
    x0, cw = ref.center_window(16, 0.8)
    assert (y0, ch, x0, cw) == (2, 9, 2, 12)
    assert float(out.max()) <= 1.0 and float(out.min()) >= 0.0
