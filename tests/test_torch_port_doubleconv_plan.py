"""K2's tile plan (ops/doubleconv.py:k2_tile_plan) on the CPU: the class each shape
gets, the shared memory it plans within a block's 232,448 B, the refusal of a Cmid
that no class fits, and the plan's mirror of the kernel source's class table."""

import os
import re

import pytest

from ted_spad_tpu_torch.chip_probes import K2_CLASS_RAGGED, UNET_DOUBLECONVS, UNETPP_CLUSTER
from ted_spad_tpu_torch.ops import doubleconv as dc

_SHAPES = (
    [(name, (s, s, ci, cm, co)) for name, s, ci, cm, co in UNET_DOUBLECONVS + UNETPP_CLUSTER]
    + [(name, shape[1:]) for name, shape in K2_CLASS_RAGGED]
    + [("ragged", (13, 17, 24, 16, 8)), ("halo", (28, 28, 16, 8, 8))]
)


def _intended_class(cmid: int) -> str:
    return "16x16" if cmid <= 64 else "16x28" if cmid <= 128 else "14x14" if cmid <= 256 else "7x14"


@pytest.mark.parametrize("name,shape", _SHAPES, ids=[name for name, _ in _SHAPES])
def test_plan_picks_the_class_and_fits(name, shape):
    h, w, cin, cmid, cout = shape
    plan = dc.k2_tile_plan(h, w, cin, cmid, cout)
    assert plan.tile_class == _intended_class(cmid)
    if name.startswith("ragged "):  # one ragged case per class, H and W off its tile
        assert name == f"ragged {plan.tile_class}"
        th, tw = map(int, plan.tile_class.split("x"))
        assert h % th and w % tw
    assert 0 < plan.smem_bytes <= dc.SMEM_PER_BLOCK


def test_plan_shared_memory_of_each_class():
    # The conv1 tile plus two ring stages, as csrc/doubleconv.cu lays them out.
    assert dc.k2_tile_plan(224, 224, 3, 64, 64).smem_bytes == 46_720 + 2 * 30_720
    assert dc.k2_tile_plan(112, 112, 64, 128, 128).smem_bytes == 146_944 + 2 * 42_240
    assert dc.k2_tile_plan(56, 56, 128, 256, 256).smem_bytes == 135_168 + 2 * 36_352
    assert dc.k2_tile_plan(28, 28, 1024, 512, 256).smem_bytes == 149_760 + 2 * 30_336


@pytest.mark.parametrize("cmid", [513, 1024])
def test_plan_refuses_a_cmid_too_wide(cmid):
    with pytest.raises(ValueError, match="Cmid"):
        dc.k2_tile_plan(28, 28, 64, cmid, 64)


def test_plan_refuses_empty_sizes():
    with pytest.raises(ValueError, match="positive"):
        dc.k2_tile_plan(0, 8, 16, 16, 16)


def test_plan_mirrors_the_kernel_source():
    src = os.path.join(os.path.dirname(dc.__file__), os.pardir, "csrc", "doubleconv.cu")
    with open(src) as f:
        classes = re.findall(r"using Class\w+ = Cls<([\d, ]+)>;\s*// Cmid <= (\d+)", f.read())
    table = tuple((int(limit), *map(int, args.split(", "))) for args, limit in classes)
    assert table == dc._K2_CLASSES
