"""Typed configuration of the serving path: the fields of ted_spad_tpu's
``StageParams`` / ``FeatureExtractionParams`` / ``MGFNParams`` that the port reads,
with the same names and defaults so one configuration reads the same in both."""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
from typing import Any


@dataclasses.dataclass
class StageParams:
    """Fields shared by every stage."""

    batch_size: int = 8
    reso_h: int = 224
    reso_w: int = 224
    compute_dtype: str = "bfloat16"
    seed: int = 0

    def replace(self, **kw: Any):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class FeatureExtractionParams(StageParams):
    """Clip feature extraction (feature_extraction/params_feature_ex.py)."""

    num_frames: int = 16
    fix_skip: int = 2
    batch_size: int = 1  # clips per device step
    cropping_factor: float = 0.8
    no_ar_distortion: bool = False
    anonymized: bool = True
    arch_fa: str = "unet++"
    arch_ft: str = "largei3d"
    # Options of the JAX package that the port implements at their defaults only;
    # any other value (and no_ar_distortion=True) raises NotImplementedError.
    quirk_compat: bool = False
    ncrops: int = 1
    quant: str = "none"

    # DALI-equivalent windowing (dali_extraction.py:72-73): 16 frames, stride 2, step 32.
    @property
    def clip_stride(self) -> int:
        return self.fix_skip

    @property
    def clip_step(self) -> int:
        return self.num_frames * self.fix_skip


@dataclasses.dataclass
class MGFNParams:
    """MGFN anomaly model (anomaly_detection_mgfn/option.py:4-65), inference fields."""

    feature_size: int = 2048
    mag_ratio: float = 0.1
    depths: tuple[int, int, int] = (3, 3, 2)
    mgfn_types: tuple[str, str, str] = ("gb", "fb", "fb")
    dims: tuple[int, int, int] = (64, 128, 1024)
    dim_head: int = 64
    ff_repe: int = 4
    local_kernel: int = 5
    k: int = 3  # top-k snippet selection (mgfn.py:184)
    datasetname: str = "UCF"  # 'UCF' | 'ST'
    seed: int = 0

    # The presets on 2048-d I3Res50 features, the port's ft (XD-Violence's 1024-d
    # preset waits for a port of its feature extractor).
    DATASET_PRESETS = {
        "UCF": dict(datasetname="UCF", feature_size=2048),
        "ST": dict(datasetname="ST", feature_size=2048),
    }

    @classmethod
    def for_dataset(cls, name: str, **overrides: Any) -> "MGFNParams":
        """Preset constructor mirroring option.py:33-58's per-dataset blocks."""
        key = {"ucf": "UCF", "st": "ST", "sh": "ST", "shanghai": "ST"}.get(
            name.lower(), name.upper()
        )
        if key not in cls.DATASET_PRESETS:
            raise ValueError(f"unknown MGFN dataset {name!r}; expected UCF or ST")
        return cls(**{**cls.DATASET_PRESETS[key], **overrides})

    def replace(self, **kw: Any):
        return dataclasses.replace(self, **kw)


def load_params_module(path: str) -> dict[str, Any]:
    """Import a reference-style ``params_*.py`` file and return its public constants.

    Drop-in equivalent of the reference's ``importlib.import_module(args.params...)``
    (train_anonymizer.py:564-566).
    """
    spec = importlib.util.spec_from_file_location("user_params", path)
    if spec is None or spec.loader is None:
        raise ValueError(f"cannot import params file {path!r}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["user_params"] = mod
    spec.loader.exec_module(mod)
    return {k: v for k, v in vars(mod).items() if not k.startswith("_")}


def apply_params_file(params, path: str | None):
    """Overlay a reference-style params file onto a typed dataclass, ignoring unknown keys."""
    if path is None:
        return params
    overrides = load_params_module(path)
    field_names = {f.name for f in dataclasses.fields(params)}
    known = {k: v for k, v in overrides.items() if k in field_names}
    return params.replace(**known)
