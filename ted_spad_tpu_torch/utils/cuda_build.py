"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is self-contained (it includes no header of the
repository), exposes a plain C interface and compiles into
``build/ted_spad_tpu_torch/lib<name>-<hash>.so`` under the repository root (a
directory ``.gitignore`` lists). The hash covers the source and the flags, so an
edited source rebuilds and an unchanged one loads as it is. Nothing is built at
import time: the first wrapper call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ted_spad_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-lineinfo",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def _target(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> tuple[float, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns the seconds
    nvcc took (0.0 when the library was built already) and its output, the ptxas
    register/spill report, kept beside the library. Raises with nvcc's output if the
    build fails."""
    target = _target(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lock:
        # Concurrent builders of one source build it once; other sources build alongside.
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(target) and os.path.exists(target + ".log"):
            with open(target + ".log") as f:
                return 0.0, f.read()
        tmp = f"{target}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")],
                              capture_output=True, text=True)
        seconds, out = time.perf_counter() - t0, proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed: {name}.cu (nvcc exit {proc.returncode}):\n{out}")
        with open(target + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, target)
        return seconds, out


def ptxas_report(nvcc_out: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes per kernel from nvcc's ``-Xptxas -v`` output:
    {mangled kernel name: {"registers", "spill_stores", "spill_loads"}}."""
    report: dict[str, dict[str, int]] = {}
    entry = None
    for line in nvcc_out.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = report.setdefault(m.group(1), {"registers": 0, "spill_stores": 0, "spill_loads": 0})
        elif entry is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif entry is not None and (m := re.search(r"Used (\d+) registers", line)):
            entry["registers"] = int(m.group(1))
    return report


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    build(name)
    return ctypes.CDLL(_target(name))
