"""A run with the timed path broken underneath comes out not correct: once for each
fault a cell can have (bench_port/faults.py). The harness's look for a card is skipped
(the CPU runs the port's plain paths at tiny sizes); the rest of the run is the
benchmark's own."""

import os
import time

import pytest

from bench_port import faults, run as harness
from bench_port.kinds import adv_train, extract
from bench_port.tests import tiny

ROOT = os.path.dirname(harness.BENCH_DIR)


@pytest.mark.parametrize("fault", sorted(faults.EXTRACT))
def test_extract_fault_is_not_correct(fault):
    with faults.planted("extract", fault):
        out = extract.run(cfg=tiny.config("tedspad_unetpp_i3res50"), traffic=tiny.traffic(),
                          seed=11, seconds=0.4, trace=False, t_start=time.perf_counter(),
                          device="cpu")
    line = harness.result_line(out, harness.load_benchmark(ROOT), "extract.unet", False)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_adv_train_fault_is_not_correct(fault):
    cfg = tiny.config("tedspad_unetpp_i3res50")
    cfg["anonymization"]["compute_dtype"] = "float32"
    with faults.planted("adv_train", fault):
        out = adv_train.run(cfg=cfg, traffic=tiny.traffic("adv_train_ucf101"), seed=13,
                            seconds=0.2, trace=False, t_start=time.perf_counter(), device="cpu")
    line = harness.result_line(out, harness.load_benchmark(ROOT), "adv_train.unetpp", False)
    assert line["correct"] is False, line["checks"]


def test_faults_are_lifted_after_the_block():
    setup = extract.ExtractCell.setup
    with faults.planted("extract", "stale"):
        assert extract.ExtractCell.setup is not setup
    assert extract.ExtractCell.setup is setup
