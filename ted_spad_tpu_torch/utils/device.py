"""Device selection and float32 numerics for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on. The default is CUDA; without a
    card this raises instead of falling back to the CPU. Pass ``device="cpu"`` to
    run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on a CUDA card by default; "
                "pass device='cpu' to run on the CPU"
            )
        if device.index is None:  # 'cuda' -> 'cuda:<current>', as tensors report it
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def tf32_off():
    """Full float32 convolutions and matmuls on the card inside the block: TF32 off
    for both cuDNN and cuBLAS, the caller's settings restored on exit. The
    extraction step, the MGFN scorer and the MGFN train step run inside it, so their
    float32 work (MGFN scoring and training, the f32 extraction used for fidelity
    checks) matches the CPU reference to float32 rounding; bf16 work is unaffected."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms inside the block, the caller's flag
    restored on exit. Every training step runs inside it, backward included: some of
    cuDNN's weight-gradient algorithms add partial sums with atomics, so without it a
    step does not repeat bit for bit on the card, as the JAX package's steps do under
    XLA. The algorithm is cuDNN's heuristic choice (torch's default, the port never
    autotunes), the same on every run. Serving never enters it."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or left in float64: the JAX package's ``astype(float32)``
    where its input is bf16 or f32, without narrowing a float64 reference run."""
    return x if x.dtype == torch.float64 else x.float()


def torch_dtype(name: str | None) -> torch.dtype:
    """'bfloat16' / 'float32' / None (float32) -> torch dtype."""
    dtype = getattr(torch, name) if name else torch.float32
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype
