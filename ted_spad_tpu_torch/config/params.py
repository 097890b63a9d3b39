"""Typed configuration of the port: ted_spad_tpu's ``StageParams``, ``VideoParams``,
``ReconstructionParams``, ``ActionParams``, ``AnonymizationParams``,
``PrivacyParams``, ``FeatureExtractionParams`` and ``MGFNParams`` (the fields the port
reads), with the same names and defaults so one
configuration reads the same in both. Schedule arrays (``warmup_array``,
``cosine_lr_array``) are computed from scalars, as the reference's formulas."""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import sys
from typing import Any, Sequence


def _linspace(a: float, b: float, n: int) -> list[float]:
    if n == 1:
        return [a]  # np.linspace(a, b, 1) == [a]
    step = (b - a) / (n - 1)
    return [a + step * i for i in range(n)]


@dataclasses.dataclass
class StageParams:
    """Fields shared by every stage (params_action.py:12-40, params_anonymization.py)."""

    run_id: str = "run"
    num_workers: int = 4
    batch_size: int = 8
    v_batch_size: int = 8
    learning_rate: float = 1e-4
    num_epochs: int = 100
    data_percentage: float = 1.0
    reso_h: int = 224
    reso_w: int = 224
    # Validation views.
    hflip: Sequence[int] = (0,)
    cropping_facs: Sequence[float] = (0.8,)
    # Per-epoch LR control (params_action.py:27-40): 'cosine' | 'patience_based' |
    # 'loss_based' | 'warmup_drop'.
    warmup: int = 10
    lr_patience: int = 2
    lr_reduce_factor: float = 2.0
    lr_scheduler: str = "cosine"
    opt_type: str = "adam"  # 'adam' | 'adamw' | 'sgd'
    momentum: float = 0.9
    weight_decay: float = 1e-4
    val_freq: int = 5
    compute_dtype: str = "bfloat16"
    seed: int = 0

    @property
    def warmup_array(self) -> list[float]:
        # params_anonymization.py:36: np.linspace(0.01, 1, warmup) + 1e-9
        return [x + 1e-9 for x in _linspace(0.01, 1.0, self.warmup)]

    @property
    def cosine_lr_array(self) -> list[float]:
        # params_anonymization.py:48: a 5-epoch linear ramp, then a half cosine to ~0.
        ramp = _linspace(0.01, 1.0, 5)
        n = max(self.num_epochs - 5, 1)
        return ramp + [(math.cos(x) + 1) / 2 for x in _linspace(0, math.pi / 0.99, n)]

    def replace(self, **kw: Any):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class VideoParams(StageParams):
    """Clip sampling of the UCF101 stages (params_action.py:12-17)."""

    num_classes: int = 102
    num_frames: int = 16
    fix_skip: int = 2
    num_modes: int = 5
    num_skips: int = 1
    min_crop_factor_training: float = 0.6
    temporal_align: bool = False
    weak_aug: bool = False
    frame_wise_aug: bool = False  # per-frame colour jitter (ucf101_dl.py:127-135)
    no_ar_distortion: bool = False
    aspect_ratio_aug: bool = False
    ori_reso_h: int = 240
    ori_reso_w: int = 320


@dataclasses.dataclass
class ReconstructionParams(StageParams):
    """fa pretraining (fa_pretraining/parameters.py)."""

    run_id: str = "fa_recon"
    batch_size: int = 32
    learning_rate: float = 1e-3
    warmup: int = 5
    scheduled_drop: int = 5
    lr_patience: int = 0
    fix_skip: int = 2
    num_modes: int = 5
    num_skips: int = 1
    arch_fa: str = "unet++"


@dataclasses.dataclass
class ActionParams(VideoParams):
    """ft action training (action_training/params_action.py); with ``anonymized``,
    every clip passes through a frozen fa first (train_anonymized_action.py)."""

    run_id: str = "baseline_action"
    arch: str = "largei3d"
    saved_model: str | None = None
    restart: bool = False
    batch_size: int = 16
    v_batch_size: int = 16
    loss: str = "ce"  # 'ce' | 'con' (SupCon on two normalized views)
    temporal_loss: str | None = None  # 'trip' | 'con' | None
    temporal_loss_weight: float = 0.1
    temporal_distance: int | None = None
    triplet_loss_margin: float = 1.0
    ft_dropout: float = 0.0  # 0 keeps the module's default rate, 0.5 (see stages/action_training.py)
    eval_only: bool = False
    three_crop: bool = False  # two corner views beside the centre (ucf101_dl.py:199-203, 297-320)
    val_freq: int = 3
    kin_pretrained: bool = False
    anonymized: bool = False
    # The reference's scrambled fa-input reshape (train_anonymized_action.py:47-58).
    quirk_compat: bool = False
    saved_model_fa: str | None = None
    arch_fa: str = "unet++"

    @property
    def val_array(self) -> list[int]:
        # params_action.py:44
        return [1] + [5 * x for x in range(1, 8)] + [2 * x for x in range(21, 25)]


@dataclasses.dataclass
class AnonymizationParams(VideoParams):
    """The adversarial anonymizer stage (anonymization_training/params_anonymization.py)."""

    run_id: str = "baseline_anonymization"
    arch_ft: str = "largei3d"
    arch_fa: str = "unet++"
    arch_fb: str = "r50"
    saved_model_fa: str | None = None
    saved_model_ft: str | None = None
    saved_model_fb: str | None = None

    num_pa: int = 7
    data_percentage_vispr: float = 1.0
    batch_size: int = 8
    batch_size_vispr: int = 12
    learning_rate: float = 1e-5
    loss: str = "ce"  # 'ce' | 'con' (SupCon on two normalized views)
    temporal_loss: str = "trip"
    weak_aug: bool = True

    # Scaled per-model LRs (params_anonymization.py:55-57).
    fa_lr_scale: float = 0.4
    fb_lr_scale: float = 1.0
    ft_lr_scale: float = 1.0

    # Adversarial loss composition (params_anonymization.py:58-61; train_anonymizer.py:119).
    ft_loss_weight: float = 0.7
    fb_loss_weight: float = 1.0
    temporal_loss_weight: float = 0.1
    triplet_loss_margin: float = 1.0
    temporal_distance: int | None = None

    # NT-Xent (train_anonymizer.py:82): temperature 0.1, dot-product similarity.
    nt_xent_temperature: float = 0.1
    nt_xent_cosine: bool = False

    # Microbatches of the fa step (gradients and losses averaged; see
    # stages/anonymization_training.py for the contrastive losses under it).
    accum_steps: int = 1

    # Activation checkpointing in the adversarial backwards: "auto" (off below 12M
    # frame-pixels per step, else full), "on", "off", or "blocks" (each fa and ft
    # stage checkpointed on its own; stages/anonymization_training.py).
    remat: str = "auto"

    # The reference's scrambled fa-input reshape (train_anonymizer.py:86-92), on clips.
    quirk_compat: bool = False

    # Checkpoint gating (train_anonymizer.py:511): every validation above this top-1.
    save_acc_threshold: float = 0.6

    @property
    def learning_rate_fa(self) -> float:
        return self.fa_lr_scale * self.learning_rate

    @property
    def learning_rate_fb(self) -> float:
        return self.fb_lr_scale * self.learning_rate

    @property
    def learning_rate_ft(self) -> float:
        return self.ft_lr_scale * self.learning_rate

    # The reference's per-epoch scheduler block is commented out
    # (train_anonymizer.py:432-450): constant scaled LRs unless this is set, then
    # the cosine array.
    use_lr_schedule: bool = False

    @property
    def val_array(self) -> list[int]:
        # train_anonymizer.py:401.
        return [1, 5, 10, 12, 15, 20, 25, 30, 35] + [40 + x * 2 for x in range(30)]


@dataclasses.dataclass
class PrivacyParams(StageParams):
    """fb privacy-attack evaluation (privacy_training/params_privacy.py)."""

    run_id: str = "default_privacy"
    saved_model: str | None = None  # fa checkpoint when anon=True
    anon: bool = False
    num_pa: int = 7
    batch_size: int = 32
    v_batch_size: int = 32
    learning_rate: float = 1e-3
    warmup: int = 5
    lr_reduce_factor: float = 5.0
    lr_patience: int = 0


@dataclasses.dataclass
class FeatureExtractionParams(StageParams):
    """Clip feature extraction (feature_extraction/params_feature_ex.py)."""

    run_id: str = "feature_extraction"
    num_classes: int = 102
    num_frames: int = 16
    fix_skip: int = 2
    batch_size: int = 1  # clips per device step
    cropping_factor: float = 0.8
    no_ar_distortion: bool = False
    anonymized: bool = True
    arch_fa: str = "unet++"
    arch_ft: str = "largei3d"
    quirk_compat: bool = False  # the reference's fa-return reshape (stages/feature_extraction.py)
    ncrops: int = 1  # 1, 5 or 10 crops per clip
    # Opt-in W8A8 int8 serving mode of the fa (ops/quant_unetpp.py): "none" (bf16) or
    # "int8". Activation scales come from the run's first ``quant_calib_batches``
    # batches; with ``quant_fidelity_check`` the stage reports the int8 features' cosine
    # to the bf16 path's on the first one. ``quant_ft`` quantizes the I3Res50 ft too
    # (other ft architectures stay bf16, with a log line).
    quant: str = "none"
    quant_calib_batches: int = 2
    quant_fidelity_check: bool = True
    quant_ft: bool = True

    # DALI-equivalent windowing (dali_extraction.py:72-73): 16 frames, stride 2, step 32.
    @property
    def clip_stride(self) -> int:
        return self.fix_skip

    @property
    def clip_step(self) -> int:
        return self.num_frames * self.fix_skip


@dataclasses.dataclass
class MGFNParams:
    """MGFN anomaly stage (anomaly_detection_mgfn/option.py:4-65, config.py:4-12):
    the model, its training and its datasets."""

    feature_size: int = 2048
    mag_ratio: float = 0.1
    seg_length: int = 32
    depths: tuple[int, int, int] = (3, 3, 2)
    mgfn_types: tuple[str, str, str] = ("gb", "fb", "fb")
    dims: tuple[int, int, int] = (64, 128, 1024)
    dim_head: int = 64
    ff_repe: int = 4
    local_kernel: int = 5
    dropout_rate: float = 0.7  # magnitude dropout before the top-k selection (train only)
    k: int = 3  # top-k snippet selection (mgfn.py:184)

    # Training (option.py:26-31; main.py:72). ``lr_schedule`` is config.py:6's per-epoch
    # LR list, stepped per epoch (main.py:91-93); None keeps ``lr``.
    lr: float = 1e-3
    lr_schedule: tuple | None = None
    batch_size: int = 16  # videos per half-batch (normal and abnormal)
    weight_decay: float = 5e-4
    max_epoch: int = 1000

    # Loss weights (train.py:74, 96-100).
    contrastive_margin: float = 200.0
    lambda_smooth: float = 8e-4
    lambda_sparse: float = 8e-3

    # Dataset (option.py:33-58; datasets/dataset.py:26-48).
    datasetname: str = "UCF"  # 'UCF' | 'ST' | 'XD'
    rgb_list: str = "data/ucf-i3d.list"
    test_rgb_list: str = "data/ucf-i3d-test.list"
    gt: str = "data/gt-ucf.npy"
    model_name: str = "mgfn_ucf"
    # Original frames per extracted clip when clip scores are expanded to the frame gt:
    # UCF/XD 32 (make_gt_ucf.py:25, make_gt_xd.py:26), ST 16 (make_gt_sh.py:32).
    frames_per_clip: int = 32
    seed: int = 0

    # The per-dataset blocks of option.py:33-58. XD's 1024-d features come from the
    # "i3d" ft (InceptionI3d).
    DATASET_PRESETS = {
        "UCF": dict(
            datasetname="UCF", feature_size=2048, frames_per_clip=32,
            rgb_list="data/ucf-i3d.list", test_rgb_list="data/ucf-i3d-test.list",
            gt="data/gt-ucf.npy", model_name="mgfn_ucf",
        ),
        "ST": dict(
            datasetname="ST", feature_size=2048, frames_per_clip=16,
            rgb_list="data/shanghai-i3d.list", test_rgb_list="data/shanghai-i3d-test.list",
            gt="data/gt-sh.npy", model_name="mgfn_sh",
        ),
        "XD": dict(
            datasetname="XD", feature_size=1024, frames_per_clip=32,
            rgb_list="data/xd-i3d.list", test_rgb_list="data/xd-i3d-test.list",
            gt="data/gt-xd.npy", model_name="mgfn_xd",
        ),
    }

    @classmethod
    def for_dataset(cls, name: str, **overrides: Any) -> "MGFNParams":
        """Preset constructor mirroring option.py:33-58's per-dataset blocks."""
        key = {"ucf": "UCF", "st": "ST", "sh": "ST", "shanghai": "ST", "xd": "XD"}.get(
            name.lower(), name.upper()
        )
        if key not in cls.DATASET_PRESETS:
            raise ValueError(f"unknown MGFN dataset {name!r}; expected UCF, ST or XD")
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
