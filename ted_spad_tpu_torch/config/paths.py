"""Dataset and artifact paths (counterpart of ted_spad_tpu/config/paths.py; reference
aux_code/config.py:1-24): one overridable place for dataset roots and artifact
directories, built from environment variables or a JSON file."""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path


@dataclasses.dataclass
class PathConfig:
    # Dataset roots (aux_code/config.py:4-20).
    ucf_crimes_path: str = "/data/UCF_Crimes"
    xd_path: str = "/data/XD_Violence"
    shanghai_path: str = "/data/shanghaitech"
    vispr_path: str = "/data/vispr_resized"
    ucf101_path: str = "/data/UCF101"
    # Artifact directories (aux_code/config.py:22-23).
    saved_models_dir: str = "saved_models"
    logs_dir: str = "logs"
    features_dir: str = "features"

    @property
    def action_splits_path(self) -> str:
        return os.path.join(self.ucf_crimes_path, "Action_Regnition_splits")

    @property
    def class_idx_path(self) -> str:
        return os.path.join(self.action_splits_path, "ClassIDs.txt")

    @property
    def ucf101_class_mapping(self) -> str:
        return os.path.join(self.ucf101_path, "ucfTrainTestlist", "action_classes.json")

    @classmethod
    def from_env(cls, prefix: str = "TEDSPAD_") -> "PathConfig":
        """From environment variables, e.g. TEDSPAD_UCF101_PATH."""
        kwargs = {f.name: os.environ[prefix + f.name.upper()] for f in dataclasses.fields(cls)
                  if prefix + f.name.upper() in os.environ}
        return cls(**kwargs)

    @classmethod
    def from_file(cls, path: str | Path) -> "PathConfig":
        with open(path) as fh:
            return cls(**json.load(fh))

    def ensure_dirs(self) -> None:
        for d in (self.saved_models_dir, self.logs_dir, self.features_dir):
            Path(d).mkdir(parents=True, exist_ok=True)


def default_paths() -> PathConfig:
    return PathConfig.from_env()
