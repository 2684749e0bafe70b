"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device. With
no CUDA device present they raise instead of carrying on elsewhere; the CPU
is used only when passed explicitly (``device="cpu"``, as the tests do).
"""
from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; raise if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "present; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def rank_device(device=None, local_rank: int | None = None) -> torch.device:
    """The device of one rank of a multi-process mesh: ``cuda:{local_rank}``
    by default (``LOCAL_RANK`` when it is set, as ``torchrun`` sets it, else
    the ``local_rank`` given, else 0). Any other device, two ranks on one
    card among them, is used only when passed explicitly; with no CUDA
    device the default raises, as ``resolve_device`` does."""
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "present; pass device='cpu' to run the plain PyTorch path")
    env = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(env) if env is not None else int(local_rank or 0))


def disable_tf32() -> None:
    """Keep f32 matmuls and convolutions in full f32 (TF32 keeps about three
    decimal digits), so f32 results can be held to the reference's 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
