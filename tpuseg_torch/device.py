"""Explicit device selection: the port never guesses where it runs."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cpu"``, ``"cuda"`` or ``"cuda:N"`` -> ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is asked for and none is
    available: a run that asked for the card never falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return device
