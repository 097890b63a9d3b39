"""Readings that set the limits of ``correct``, on the card, at a cell's own size.

    python3 -m bench_port.control --workload extract.unet --seeds 11,12,13 --seconds 3

For each seed, in one process: the cell's set-up, a short window at the cell's own
load, then the numbers the check compares, twice: for the program's outputs (the
lower readings; sound runs), and for the control, the float32 reference computed
instead in float8 (every convolution and matrix product's operands rounded to e4m3,
their gradients to e5m2), a precision below the served bf16 (the upper readings). One
JSON line per seed, then a summary: each number's largest program reading and
smallest control reading. With ``--fault <name>`` (bench_port/faults.py) the program
runs with that fault planted, and its readings are the fault's. The benchmark's own
runs never run the control or a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

import torch

from bench_port import faults, run as harness


def readings(cell_cls, cfg, traffic, seed: int, seconds: float, device) -> dict:
    cell = cell_cls(cfg, traffic, seed, device, time.perf_counter())
    cell.setup(build=device.type == "cuda")
    cell.window(seconds, False)
    cell.free_program()
    out = {"seed": seed, **cell.control_report(), "window_s": cell.record["window_s"]}
    del cell
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def summarize(rows: list[dict]) -> dict:
    names = rows[0]["program"].keys()
    return {n: {"program_max": max(r["program"][n] for r in rows),
                "control_min": min(r["control"][n] for r in rows)} for n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None, help="a fault of bench_port/faults.py to plant")
    args = ap.parse_args(argv)
    harness.set_cache_dirs(os.getcwd())
    bench = harness.load_benchmark(os.getcwd())
    cell = harness.cell_of(bench, args.workload)
    cfg, traffic = harness.load_config(cell["config"]), harness.load_traffic(cell["traffic"])
    kind = harness.kind_module(traffic["kind"])
    device = torch.device("cuda", 0)
    rows = []
    planted = (faults.planted(traffic["kind"], args.fault) if args.fault
               else contextlib.nullcontext())
    with planted:
        for seed in (int(s) for s in args.seeds.split(",")):
            rows.append(readings(kind.CELL, cfg, traffic, seed, args.seconds, device))
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"summary": summarize(rows), "device": torch.cuda.get_device_name(device)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
