"""The check that no module of JAX or of the JAX package is loaded compares whole
top-level names."""

import subprocess
import sys

import pytest

from bench_port.run import FORBIDDEN, forbidden_modules


@pytest.mark.parametrize("names, found", [
    (["ted_spad_tpu_torch", "ted_spad_tpu_torch.models.unet"], []),
    (["ted_spad_tpu", "ted_spad_tpu.ops.losses"], ["ted_spad_tpu"]),
    (["ted_spad_tpu_torch.ops", "ted_spad_tpu.models"], ["ted_spad_tpu"]),
    (["jax", "jax._src.core"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen", "flaxen", "jaxtyping", "ted_spad_tpux"], ["flax"]),
    (["numpy", "torch", "bench_port.run"], []),
])
def test_top_level_names_compared_whole(names, found):
    assert forbidden_modules(names) == found


def test_forbidden_names():
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "ted_spad_tpu"}


def test_a_run_loads_no_forbidden_module():
    """A whole tiny run of each kind, in a process of its own, leaves none loaded."""
    code = (
        "import sys, time\n"
        "from bench_port.tests import tiny\n"
        "from bench_port.kinds import extract, adv_train\n"
        "from bench_port.run import forbidden_modules\n"
        "cfg = tiny.config('tedspad_unetpp_i3res50')\n"
        "extract.run(cfg=cfg, traffic=tiny.traffic(), seed=1, seconds=0.1, trace=False,"
        " t_start=time.perf_counter(), device='cpu')\n"
        "cfg['anonymization']['compute_dtype'] = 'float32'\n"
        "adv_train.run(cfg=cfg, traffic=tiny.traffic('adv_train_ucf101'), seed=1, seconds=0.1,"
        " trace=False, t_start=time.perf_counter(), device='cpu')\n"
        "print('FORBIDDEN', forbidden_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import bench_port.reference.models, bench_port.reference.augment\n"
            "import bench_port.reference.adversarial\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ted_spad_tpu_torch', 'ted_spad_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
