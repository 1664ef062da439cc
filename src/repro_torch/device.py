"""Where the port runs: the card by default, the CPU only when asked."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and there
    is no card, so a default call never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def check_on_device(tensor: torch.Tensor, device: torch.device, what: str):
    """Raise unless ``tensor`` lies on ``device`` (index-insensitive for a
    bare ``cuda``)."""
    if tensor.device.type != device.type or (
            device.index is not None and tensor.device.index != device.index):
        raise ValueError(f"{what} on {tensor.device}, expected {device}")
