"""The device the port's classes and step builders run on by default."""
from __future__ import annotations

import torch

__all__ = ["default_device"]


def default_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` picks the first CUDA
    device when there is one, else the CPU (as JAX runs on its default
    accelerator)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)
