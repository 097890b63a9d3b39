"""The one line a run prints, and the runs that print none."""

import json
import os

import pytest

from bench_port import run as harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _out(trace: bool) -> dict:
    rec = {"step_ms": [30.0, 32.0], "score_ms": [2.0], "model_flops": 1e15, "window_s": 10.0,
           "trace": {"busy_s": 1.5, "window_s": 2.0, "kernels": {}, "device_ops": [["k", 1.0]],
                     "idle_gaps": [["bench.pack", 0.4]]}}
    out = {"correct": True, "attempted": 40, "failed": 0, "record": rec,
           "e2e": {"clips_per_s": 412.5, "setup_s": 31.25},
           "checks": {"feat_err": (0.05, 0.5), "score_err": (1e-7, 1e-3)},
           "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                      "memory_peak_bytes": 123}}
    if trace:
        out["breakdown"] = {"device_ops": [["k", 1.0]], "idle_gaps": [["bench.pack", 0.4]]}
        out["device"] = {**out["device"], "busy_s": 1.5, "window_s": 2.0}
    return out


def test_untraced_line_has_the_end_to_end_metrics_and_checks_last():
    line = harness.result_line(_out(False), harness.load_benchmark(ROOT), "extract.unet", False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["metrics"] == {"clips_per_s": {"value": 412.5, "unit": "clips/s"},
                               "setup_s": {"value": 31.25, "unit": "s"}}
    assert line["checks"]["feat_err"] == {"value": 0.05, "limit": 0.5}
    assert json.loads(json.dumps(line)) == line


def test_traced_line_has_per_layer_metrics_device_times_and_breakdown():
    line = harness.result_line(_out(True), harness.load_benchmark(ROOT), "extract.unet", True)
    assert list(line)[-1] == "checks"
    assert line["metrics"]["step_ms.extract"] == {"value": 31.0, "unit": "ms"}
    assert line["metrics"]["device_idle.extract"]["value"] == pytest.approx(25.0)
    assert line["metrics"]["mfu.extract"]["value"] == pytest.approx(100 * 1e14 / 989e12)
    assert "k2_roofline.extract" not in line["metrics"]
    assert line["device"]["busy_s"] == 1.5 and line["breakdown"]["idle_gaps"]


def test_no_card_exits_non_zero_without_a_result(capsys, monkeypatch):
    import torch

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "extract.unet", "--seed", "1", "--seconds", "1",
                       "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_module_exits_non_zero_without_a_result(capsys, monkeypatch):
    import sys
    import types

    import torch

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    fake_kind = types.SimpleNamespace(run=lambda **kw: _out(False))
    monkeypatch.setattr(harness, "kind_module", lambda kind, bench_dir=None: fake_kind)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = harness.main(["--workload", "extract.unet", "--seed", "1", "--seconds", "1",
                       "--trace", "0"])
    assert rc != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err


def test_a_run_prints_its_line_last(capsys, monkeypatch):
    import types

    import torch

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    fake_kind = types.SimpleNamespace(run=lambda **kw: _out(False))
    monkeypatch.setattr(harness, "kind_module", lambda kind, bench_dir=None: fake_kind)
    assert harness.main(["--workload", "extract.unet", "--seed", str(2**31 + 12345),
                         "--seconds", "1", "--trace", "0"]) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert captured.err.strip().splitlines()[-1].startswith("check score_err")
