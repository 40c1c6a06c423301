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


def card_label(device: torch.device) -> str:
    """The card a measurement ran on, as `nvidia-smi --query-gpu=name,power.limit` gives it
    (a card set below its full power limit runs slower under load); "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    import subprocess

    index = torch.cuda.current_device() if device.index is None else device.index
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
