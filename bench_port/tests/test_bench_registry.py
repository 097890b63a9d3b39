"""Cells, configurations, traffic mixes and per-layer metrics are found by name: a new
cell and a new metric are new files and new entries, and no existing file changes."""

import json
import os
import shutil

import pytest

from bench_port import run as harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "bench_port")


def _bench() -> dict:
    return harness.load_benchmark(ROOT)


def test_every_cell_config_traffic_and_metric_resolves():
    b = _bench()
    for cell in b["workloads"]:
        harness.load_config(cell["config"])
        traffic = harness.load_traffic(cell["traffic"])
        assert hasattr(harness.kind_module(traffic["kind"]), "run")
        assert harness.end_to_end_of(b, cell["name"])
        assert harness.per_layer_of(b, cell["name"])
    for m in b["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read)
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    b = _bench()
    for cell in b["workloads"]:
        e2e = {m["name"] for m in harness.end_to_end_of(b, cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in harness.per_layer_of(b, cell["name"]):
            assert m["moves"] in e2e


def test_a_new_cell_and_metric_are_taken_without_editing_a_file(tmp_path):
    bench_dir = tmp_path / "bench_port"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "traffic" / "archive_short.json").write_text(json.dumps(
        {**harness.load_traffic("archive_240p"), "clips_min": 2, "clips_max": 8}))
    (bench_dir / "metrics" / "clips_seen.extract.py").write_text(
        '"""Clips extracted in the window."""\n\n\n'
        'def read(record):\n    return record.get("clips")\n')
    b = _bench()
    b["workloads"].append({"name": "extract.short", "config": "tedspad_unetpp_i3res50",
                           "traffic": "archive_short", "chips": 1, "why": "short videos"})
    for m in b["end_to_end"]:
        if m["name"] == "clips_per_s":
            m["workloads"].append("extract.short")
    b["per_layer"].append({"name": "clips_seen.extract", "unit": "clips", "better": "higher",
                           "source": "program_counter", "layer": "extraction step",
                           "moves": "clips_per_s", "workloads": ["extract.short"]})
    assert harness.load_traffic("archive_short", str(bench_dir))["clips_max"] == 8
    assert harness.kind_module("extract", str(bench_dir)).CELL.__name__ == "ExtractCell"
    names = [m["name"] for m in harness.per_layer_of(b, "extract.short")]
    assert names == ["clips_seen.extract"]
    assert harness.read_per_layer(b, "extract.short", {"clips": 17}, str(bench_dir)) == {
        "clips_seen.extract": {"value": 17.0, "unit": "clips"}}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_metric_without_a_cell_list_is_reported_wherever_its_end_to_end_metric_is():
    b = _bench()
    b["per_layer"].append({"name": "clips_seen.any", "unit": "clips", "better": "higher",
                           "source": "program_counter", "layer": "extraction step",
                           "moves": "clips_per_s"})
    assert "clips_seen.any" in [m["name"] for m in harness.per_layer_of(b, "extract.unet")]
    assert "clips_seen.any" not in [m["name"] for m in harness.per_layer_of(b, "adv_train.unetpp")]


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    b = _bench()
    got = harness.read_per_layer(b, "extract.unet", {})
    assert got == {}


@pytest.mark.parametrize("name", ["extract.unet", "adv_train.unetpp"])
def test_names_follow_the_contract(name):
    import re

    b = _bench()
    pat = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    assert pat.match(name) and harness.cell_of(b, name)
    for m in b["end_to_end"] + b["per_layer"] + b["configs"] + b["workloads"]:
        assert pat.match(m["name"])
        if "unit" in m:
            assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
