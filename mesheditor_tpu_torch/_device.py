"""Device resolution shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device. A CUDA device without a usable card raises: the port
    never falls back to the CPU behind the caller's back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the host"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (stage timers measure work, not its enqueue)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
