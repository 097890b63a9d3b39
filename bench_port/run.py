"""The benchmark of the PyTorch port (``ted_spad_tpu_torch``) on one NVIDIA card.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. One call runs one cell once and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown`` with ``--trace
1``, and last ``checks``: each number that decided ``correct`` beside its limit.

Everything is found by name, so a later cell or metric is new files and new entries:

- ``BENCHMARK.json`` (the checkout's root): the cells, their configuration and
  traffic mix, and the metrics with the cells each is reported in;
- ``bench_port/configs/<config>.json``: the model configuration as it is run;
- ``bench_port/traffic/<traffic>.json``: a traffic mix, a file of parameters whose
  ``kind`` names the generator and runner ``bench_port/kinds/<kind>.py``;
- ``bench_port/metrics/<metric>.py``: the reader of one per-layer metric, which takes
  it from the run's record (spans, counters, the trace) and returns None where it
  finds nothing to read.

Exit codes: 0 with a result; 2 when the cell needs more CUDA cards than there are (no
result); 3 when a module of JAX or of the JAX package was loaded (no result).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# Top-level module names that must not be loaded in the process that prints a result.
FORBIDDEN = ("jax", "jaxlib", "flax", "ted_spad_tpu")


def forbidden_modules(names) -> list[str]:
    """The forbidden top-level names among module names, compared whole (the part
    before the first dot): ``ted_spad_tpu_torch`` is not ``ted_spad_tpu``."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, kind, name + ".json")) as f:
        return json.load(f)


def load_config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _load_json("configs", name, bench_dir)


def load_traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _load_json("traffic", name, bench_dir)


def load_file_module(path: str, name: str):
    """A module from a file path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str, bench_dir: str = BENCH_DIR):
    if bench_dir == BENCH_DIR:
        return importlib.import_module(f"bench_port.kinds.{kind}")
    return load_file_module(os.path.join(bench_dir, "kinds", kind + ".py"), f"bench_kind_{kind}")


def metric_module(name: str, bench_dir: str = BENCH_DIR):
    return load_file_module(os.path.join(bench_dir, "metrics", name + ".py"),
                            "bench_metric_" + name.replace(".", "_").replace("-", "_"))


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def end_to_end_of(bench: dict, workload: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]


def per_layer_of(bench: dict, workload: str) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and those without a
    list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, workload)}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in e2e else [])]


def read_per_layer(bench: dict, workload: str, record: dict, bench_dir: str = BENCH_DIR) -> dict:
    """{name: {"value", "unit"}} of every per-layer metric of the cell its reader finds
    something for."""
    out = {}
    for m in per_layer_of(bench, workload):
        value = metric_module(m["name"], bench_dir).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache of the run inside the checkout, at fixed paths
    (the port builds its kernels under ``build/ted_spad_tpu_torch`` by itself)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["USE_FLAX"] = "0"  # transformers, if anything loads it, stays off JAX


def result_line(out: dict, bench: dict, workload: str, trace: bool) -> dict:
    """The printed result: end-to-end metrics (or per-layer ones when traced), the
    device, the breakdown, and the checks last."""
    if trace:
        metrics = read_per_layer(bench, workload, out["record"])
    else:
        units = {m["name"]: m["unit"] for m in end_to_end_of(bench, workload)}
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in out["e2e"].items()
                   if k in units}
    line = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": out["device"]}
    if trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    root = os.getcwd()
    set_cache_dirs(root)
    bench = load_benchmark(root)
    cell = cell_of(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench_port: {args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cfg = load_config(cell["config"])
    traffic = load_traffic(cell["traffic"])
    kind = kind_module(traffic["kind"])
    out = kind.run(cfg=cfg, traffic=traffic, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), t_start=T_START, chips=cell["chips"])
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"bench_port: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(out, bench, args.workload, bool(args.trace))
    if "host_s" in out["record"]:
        print("host " + " ".join(f"{k}={v:.3f}s" for k, v in out["record"]["host_s"].items())
              + f" batches={out['record']['batches']}", file=sys.stderr)
    if "diag" in out["record"]:
        print("diag " + json.dumps(out["record"]["diag"]), file=sys.stderr)
    phases = out["record"].get("setup_phases", {})
    print("setup " + " ".join(f"{k}={v:.3f}s" for k, v in phases.items()), file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
