"""Model zoo + factories of the port (counterpart of ted_spad_tpu/models/__init__.py).

``load_fa_model`` / ``load_ft_model`` / ``load_fb_model`` / ``load_mgfn_model`` build a
module in eval
mode with weights drawn from a seeded ``torch.Generator``, cast to ``dtype`` and
placed on ``device`` (CUDA by default; see utils/device.py). Trained weights come
from ``saved_model_file``, a checkpoint the JAX package (or the port) wrote, read
under the same key as the JAX loaders read it, or from
``utils.jax_weights.load_jax_variables``; either replaces every weight.
"""

from __future__ import annotations

import torch
from torch import nn

from ted_spad_tpu_torch.models.i3d import InceptionI3d
from ted_spad_tpu_torch.models.i3res50 import I3Res50, MlpHead, NonLocalBlock3D, WrapperI3D
from ted_spad_tpu_torch.models.mgfn import MGFN
from ted_spad_tpu_torch.models.mvit import MViTv2S
from ted_spad_tpu_torch.models.r3d import R3D18
from ted_spad_tpu_torch.models.resnet2d import ResNet2D, ResNet50Classifier, ResNet50SSL
from ted_spad_tpu_torch.models.unet import UNet, UNetPlusPlus
from ted_spad_tpu_torch.utils.device import resolve_device, torch_dtype
from ted_spad_tpu_torch.utils.jax_weights import load_jax_checkpoint, load_jax_variables

__all__ = [
    "FT_FEATURE_DIMS",
    "I3Res50",
    "InceptionI3d",
    "MGFN",
    "MViTv2S",
    "MlpHead",
    "NonLocalBlock3D",
    "R3D18",
    "ResNet2D",
    "ResNet50Classifier",
    "ResNet50SSL",
    "UNet",
    "UNetPlusPlus",
    "WrapperI3D",
    "load_fa_model",
    "load_fb_model",
    "load_ft_model",
    "load_mgfn_model",
]

# Reduced widths/depths for CPU tests: the same architectures, never used for weight parity
# with a trained model.
_TINY_FT_SPECS = ((8, 1, 1, (1,)), (16, 1, 2, (1,)), (32, 1, 2, (1,)), (64, 1, 2, (0,)))

# Width of each ft architecture's clip feature (extract_features), as the extraction
# stage writes it and MGFN's feature_size must match.
FT_FEATURE_DIMS = {"largei3d": 2048, "i3d": 1024, "r3d_18": 512, "mvitv2": 768}


def _place(model: nn.Module, device, dtype: torch.dtype, channels_last: str | None) -> nn.Module:
    device = resolve_device(device)
    model = model.to(device=device, dtype=dtype).eval().requires_grad_(False)
    if device.type == "cuda" and channels_last:
        model = model.to(memory_format=getattr(torch, channels_last))
    return model


def load_fa_model(
    arch: str = "unet++",
    *,
    saved_model_file: str | None = None,
    seed: int = 0,
    dtype: str | None = "bfloat16",
    tiny: bool = False,
    device: str | torch.device = "cuda",
) -> UNetPlusPlus | UNet:
    """Anonymizer factory (model_loaders.py:17-53): ``arch='unet++'`` (the default)
    or ``'unet'``. ``tiny`` exists for UNet++ only, as in the JAX package."""
    g = torch.Generator().manual_seed(seed)
    if arch == "unet++":
        if tiny:
            model = UNetPlusPlus(decoder_channels=(16, 8, 8, 8), encoder_layers=(1, 1, 1, 1),
                                 encoder_width=8, generator=g)
        else:
            model = UNetPlusPlus(generator=g)
    elif arch == "unet":
        if tiny:
            raise ValueError("the UNet fa has no tiny variant; build it at full width")
        model = UNet(generator=g)
    else:
        raise ValueError(f"Architecture {arch!r} invalid for fa_model. Try 'unet' or 'unet++'")
    if saved_model_file:
        load_jax_checkpoint(model, saved_model_file, "fa_model_state_dict")
    return _place(model, device, torch_dtype(dtype), "channels_last")


def load_ft_model(
    arch: str = "largei3d",
    *,
    saved_model_file: str | None = None,
    num_classes: int = 400,
    dropout_rate: float | None = None,
    clip_shape: tuple[int, int, int] = (16, 224, 224),
    seed: int = 0,
    dtype: str | None = "bfloat16",
    tiny: bool = False,
    device: str | torch.device = "cuda",
) -> WrapperI3D | InceptionI3d | R3D18 | MViTv2S:
    """Utility model factory (model_loaders.py:56-91): ``"largei3d"`` (I3Res50, the
    default), ``"i3d"`` (InceptionI3d), ``"r3d_18"`` or ``"mvitv2"`` (MViTv2-S, built
    for ``clip_shape``, (T, H, W), which sizes its rel-pos tables). Each has
    ``extract_features`` (FT_FEATURE_DIMS wide) and holds its classifier
    (``num_classes``), as the JAX modules do; ``dropout_rate`` is I3Res50's and
    InceptionI3d's (None keeps the module default, 0.5). The largei3d wrapper holds
    the MLP head too, and reads its classifier's width from a checkpoint that has
    one (as the JAX package's restore takes the checkpoint's arrays), so an action
    checkpoint of any class count serves. ``tiny`` exists for ``"largei3d"`` only,
    as in the JAX package."""
    if tiny and arch != "largei3d":
        raise ValueError(f"tiny variant only exists for 'largei3d', not {arch!r}")
    g = torch.Generator().manual_seed(seed)
    kw = {"dropout_rate": dropout_rate} if dropout_rate is not None else {}
    tree = None
    if saved_model_file:
        from ted_spad_tpu_torch.utils.checkpoint import load_checkpoint

        state = load_checkpoint(saved_model_file)
        tree = state.get("ft_model_state_dict", state)
    if arch == "largei3d":
        if tiny:
            kw.update(layer_specs=_TINY_FT_SPECS, stem_width=8)
        fc = (tree or {}).get("params", {}).get("i3d", {}).get("fc")
        if fc is not None:
            num_classes = int(fc["kernel"].shape[-1])
        model = WrapperI3D(num_classes, generator=g, **kw)
    elif arch == "i3d":
        model = InceptionI3d(num_classes, generator=g, **kw)
    elif arch == "r3d_18":
        model = R3D18(num_classes, generator=g)
    elif arch == "mvitv2":
        model = MViTv2S(num_classes, clip_shape=tuple(clip_shape), generator=g)
    else:
        raise ValueError(f"Architecture {arch!r} invalid for ft_model. Try 'i3d', 'largei3d', "
                         f"'mvitv2', or 'r3d_18'")
    if tree is not None:
        load_jax_variables(model, tree)
    # MViT works on token sequences; its only convs are the patch embed and the poolings.
    return _place(model, device, torch_dtype(dtype), None if arch == "mvitv2" else "channels_last_3d")


def load_fb_model(
    arch: str = "r50",
    saved_model_file: str | None = None,
    num_pa: int = 7,
    ssl: bool = False,
    *,
    image_size: tuple[int, int] = (224, 224),
    dtype: str | None = "bfloat16",
    tiny: bool = False,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> ResNet50Classifier | ResNet50SSL:
    """Privacy model factory (model_loaders.py:94-121): the ResNet-50 multi-label
    classifier of ``num_pa`` attributes, or with ``ssl`` the SimCLR model of the
    adversarial stage. ``saved_model_file`` holds ``fb_model_state_dict``. ``tiny``
    is ``layers=(1, 1, 1, 1), width=8``, as in the JAX package. ``image_size`` is
    accepted for the JAX signature (flax initializes from a dummy input of that size);
    the torch modules need none."""
    del image_size
    if arch != "r50":
        raise ValueError(f"Architecture {arch!r} invalid for fb_model. Try 'r50'")
    g = torch.Generator().manual_seed(seed)
    kw: dict = {"layers": (1, 1, 1, 1), "width": 8} if tiny else {}
    model = ResNet50SSL(generator=g, **kw) if ssl else ResNet50Classifier(num_pa, generator=g, **kw)
    if saved_model_file:
        load_jax_checkpoint(model, saved_model_file, "fb_model_state_dict")
    return _place(model, device, torch_dtype(dtype), "channels_last")


def load_mgfn_model(params=None, saved_model_file: str | None = None, *,
                    device: str | torch.device = "cuda") -> MGFN:
    """MGFN factory (anomaly_detection_mgfn/main.py:60), float32, seeded by
    ``params.seed``; ``saved_model_file`` holds ``mgfn_model_state_dict``. Returned
    in eval mode without gradients, like every factory here; a trainer turns
    ``requires_grad`` on (stages/anomaly_detection.py)."""
    from ted_spad_tpu_torch.config.params import MGFNParams

    p = params or MGFNParams()
    model = MGFN(
        feature_size=p.feature_size, dims=tuple(p.dims), depths=tuple(p.depths),
        mgfn_types=tuple(p.mgfn_types), local_kernel=p.local_kernel, ff_repe=p.ff_repe,
        dim_head=p.dim_head, mag_ratio=p.mag_ratio, dropout_rate=p.dropout_rate, k=p.k,
        generator=torch.Generator().manual_seed(p.seed),
    )
    if saved_model_file:
        load_jax_checkpoint(model, saved_model_file, "mgfn_model_state_dict")
    return _place(model, device, torch.float32, None)
