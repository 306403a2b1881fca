"""Bit/byte manipulation substrate for the GF(2)-linear coding layer.

Port of ``liquid_usrp_tpu/utils/bits.py``.  Conventions are unchanged: a
byte array is uint8 ``[..., n]``, a bit array is uint8 ``[..., n*8]`` of 0/1
values, MSB first within each byte.

GF(2) products run as float32 matmuls reduced mod 2: CUDA has no integer
matmul in torch, and 0/1 sums stay exact in float32 below 2^24 terms (far
above the largest contraction here, the 65536-row CRC basis).  That needs
full float32 precision, so the package turns TF32 off at import
(``liquid_usrp_tpu_torch/__init__.py``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["unpack_bits", "pack_bits", "gf2_matmul", "np_unpack_bits",
           "np_pack_bits"]


def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 bytes ``[..., n]`` -> bits ``[..., n*8]``, MSB first."""
    data = data.to(torch.uint8)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bits ``[..., n*8]`` (0/1) -> uint8 bytes ``[..., n]``, MSB first."""
    n = bits.shape[-1] // 8
    b = bits.reshape(*bits.shape[:-1], n, 8).to(torch.int32)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=bits.device)
    return (b * weights).sum(-1).to(torch.uint8)


def gf2_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GF(2) matrix product ``(a @ b) % 2`` computed as a float32 matmul.

    ``a``: ``[..., k]`` bits, ``b``: ``[k, n]`` bits."""
    acc = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def np_unpack_bits(data: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1)


def np_pack_bits(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1)
