"""Model zoo + factories of the port (counterpart of ted_spad_tpu/models/__init__.py).

``load_fa_model`` / ``load_ft_model`` / ``load_mgfn_model`` build a module in eval
mode with weights drawn from a seeded ``torch.Generator``, cast to ``dtype`` and
placed on ``device`` (CUDA by default; see utils/device.py). Trained weights come
from ``saved_model_file``, a checkpoint the JAX package (or the port) wrote, read
under the same key as the JAX loaders read it, or from
``utils.jax_weights.load_jax_variables``; either replaces every weight.
"""

from __future__ import annotations

import torch
from torch import nn

from ted_spad_tpu_torch.models.i3res50 import I3Res50, WrapperI3D
from ted_spad_tpu_torch.models.mgfn import MGFN
from ted_spad_tpu_torch.models.resnet2d import ResNet2D
from ted_spad_tpu_torch.models.unet import UNet, UNetPlusPlus
from ted_spad_tpu_torch.utils.device import resolve_device, torch_dtype
from ted_spad_tpu_torch.utils.jax_weights import FT_HEADS, load_jax_checkpoint

__all__ = [
    "I3Res50",
    "MGFN",
    "ResNet2D",
    "UNet",
    "UNetPlusPlus",
    "WrapperI3D",
    "load_fa_model",
    "load_ft_model",
    "load_mgfn_model",
]

# Reduced widths/depths for CPU tests: the same architectures, never used for weight parity
# with a trained model.
_TINY_FT_SPECS = ((8, 1, 1, (1,)), (16, 1, 2, (1,)), (32, 1, 2, (1,)), (64, 1, 2, (0,)))


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
    seed: int = 0,
    dtype: str | None = "bfloat16",
    tiny: bool = False,
    device: str | torch.device = "cuda",
) -> WrapperI3D:
    """Utility model factory (model_loaders.py:56-91), feature path. Only
    ``arch='largei3d'`` is ported. A checkpoint's classifier and MLP head
    (``FT_HEADS``) are not read: the feature path does not hold them."""
    if arch != "largei3d":
        raise NotImplementedError(f"ft architecture {arch!r} is not ported; use 'largei3d'")
    g = torch.Generator().manual_seed(seed)
    kw = dict(layer_specs=_TINY_FT_SPECS, stem_width=8) if tiny else {}
    model = WrapperI3D(generator=g, **kw)
    if saved_model_file:
        load_jax_checkpoint(model, saved_model_file, "ft_model_state_dict", skip=FT_HEADS)
    return _place(model, device, torch_dtype(dtype), "channels_last_3d")


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
