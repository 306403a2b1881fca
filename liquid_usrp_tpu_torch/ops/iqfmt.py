"""Reduced-precision IQ ingest formats.

Port of ``liquid_usrp_tpu/ops/iqfmt.py`` (``iq_to_planes``,
``iq_to_planes_sc8``, ``czeros`` and ``iq_from_any``).
A "planes" array is real-valued ``[2, ...]`` (row 0 = I, row 1 = Q) in
bfloat16/float16/float32 (already-scaled values) or int8/int16 full-scale
wire codes (SC8: +-127 <-> +-1.0, SC16: +-32767 <-> +-1.0).  Steps accept a
complex stream or planes; planes become complex64 on entry, so every
downstream function is unchanged.
"""
from __future__ import annotations

import torch

from ..utils.device import default_device

__all__ = ["iq_to_planes", "iq_to_planes_sc8", "czeros", "iq_from_any",
           "SC8_FULL_SCALE", "SC16_FULL_SCALE"]

SC8_FULL_SCALE = 127.0
SC16_FULL_SCALE = 32767.0


def iq_to_planes(x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Complex stream ``[...]`` -> real planes ``[2, ...]`` (rounded)."""
    return torch.stack([x.real, x.imag]).to(dtype)


def iq_to_planes_sc8(x: torch.Tensor) -> torch.Tensor:
    """Complex stream -> int8 wire-code planes ``[2, ...]``: the caller is
    the AGC (``|I|, |Q| <= 1`` is full scale); values round half to even to
    +-127 codes and out-of-range samples clip, as an 8-bit ADC would."""
    planes = torch.stack([x.real, x.imag]) * SC8_FULL_SCALE
    return torch.clamp(torch.round(planes), -127.0, 127.0).to(torch.int8)


def czeros(shape, device=None) -> torch.Tensor:
    """Complex64 zeros of ``shape`` on ``device`` (``None``: the card,
    ``utils/device.py``)."""
    if isinstance(shape, int):
        shape = (shape,)
    return torch.zeros(tuple(shape), dtype=torch.complex64,
                       device=default_device(device))


def iq_from_any(x: torch.Tensor) -> torch.Tensor:
    """Accept a complex stream or ``[2, ...]`` real planes; return complex64."""
    if x.is_complex():
        return x.to(torch.complex64)
    if x.dim() < 2 or x.shape[0] != 2:
        raise ValueError(
            f"planes input must be [2, ...] real (got {tuple(x.shape)} "
            f"{x.dtype})")
    if x.dtype == torch.int8:
        xf = x.to(torch.float32) * (1.0 / SC8_FULL_SCALE)
    elif x.dtype == torch.int16:
        xf = x.to(torch.float32) * (1.0 / SC16_FULL_SCALE)
    elif x.is_floating_point():
        xf = x.to(torch.float32)
    else:
        raise ValueError(
            f"planes must be bf16/f16/f32 (scaled) or int8/int16 (wire "
            f"codes), got {x.dtype}")
    return torch.complex(xf[0], xf[1])
