"""The device the port's classes and step builders run on by default.

``device=None`` means the first CUDA device.  Without one the port raises:
it never moves to the CPU on its own.  The caller asks for the CPU (or any
other device) by passing ``device="cpu"``, or for a whole process through
the environment variable ``LIQUID_USRP_TORCH_DEVICE`` (for example
``LIQUID_USRP_TORCH_DEVICE=cpu``), the port's counterpart of the
``JAX_PLATFORMS=cpu`` that the JAX package's apps and tests run under.
"""
from __future__ import annotations

import os

import torch

__all__ = ["default_device", "DEVICE_ENV"]

DEVICE_ENV = "LIQUID_USRP_TORCH_DEVICE"


def default_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`.  ``None`` takes
    ``$LIQUID_USRP_TORCH_DEVICE`` when it is set, else ``cuda:0``, and
    raises :class:`RuntimeError` when there is no CUDA device."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                f"device='cpu' or set {DEVICE_ENV}=cpu to run on the CPU")
        device = "cuda:0"
    return torch.device(device)
