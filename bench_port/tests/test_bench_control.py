"""The control, the float32 reference computed in float8 in the program's place, comes
out not correct, and the program comes out correct: at tiny sizes on the CPU, and at
the cells' own sizes on a card (marked ``cuda``)."""

import time

import pytest
import torch

from bench_port import run as harness
from bench_port.kinds import adv_train, extract
from bench_port.tests import tiny


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > lim for k, lim in limits.items())


def _limits(kind) -> dict:
    if kind is extract:
        return {"feat_err": extract.FEAT_ERR_LIMIT, "score_err": extract.SCORE_ERR_LIMIT}
    return dict(adv_train.LIMITS)


@pytest.mark.parametrize("kind, config, traffic", [
    (extract, "tedspad_unetpp_i3res50", "archive_240p"),
    (extract, "tedspad_unet_i3res50", "archive_240p"),
    (adv_train, "tedspad_unetpp_i3res50", "adv_train_ucf101"),
])
def test_control_fails_where_the_program_passes_tiny(kind, config, traffic):
    cfg = tiny.config(config)
    if kind is adv_train:
        cfg["anonymization"]["compute_dtype"] = "float32"
    cell = kind.CELL(cfg, tiny.traffic(traffic), 17, torch.device("cpu"), time.perf_counter())
    cell.setup(build=False)
    cell.window(0.3, False)
    cell.free_program()
    report = cell.control_report()
    limits = _limits(kind)
    assert not _fails(report["program"], limits), report
    assert _fails(report["control"], limits), report


def test_trace_union_and_gaps():
    from bench_port import trace

    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert trace.union_us(spans) == 4.0
    assert trace.gaps(spans, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["extract.unet", "adv_train.unetpp"])
def test_control_fails_where_the_program_passes_on_the_card(workload, monkeypatch):
    """At the cell's own size and load, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os

    from bench_port import control

    monkeypatch.chdir(os.path.dirname(harness.BENCH_DIR))
    bench = harness.load_benchmark(os.getcwd())
    cell = harness.cell_of(bench, workload)
    cfg, traffic = harness.load_config(cell["config"]), harness.load_traffic(cell["traffic"])
    kind = harness.kind_module(traffic["kind"])
    limits = _limits(extract if traffic["kind"] == "extract" else adv_train)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = control.readings(kind.CELL, cfg, traffic, seed, 3.0, torch.device("cuda", 0))
        assert not _fails(r["program"], limits), r
        assert _fails(r["control"], limits), r
