"""CRC-16 / CRC-32 as GF(2)-linear kernels.

Port of ``liquid_usrp_tpu/ops/crc.py``.  A CRC with ``init=0, xorout=0`` is
linear over GF(2) in the message bits, so the host precomputes (NumPy,
copied verbatim from the JAX package) the response ``basis`` of a single
1-bit at every distance from the message end and the affine part ``c0[n]``
(the CRC of ``n`` zero bytes).  At run time ``crc(m) = bits(m) @ basis % 2
^ c0[len(m)]``: one masked matmul and a table row, batched over messages.

CRC values are returned as int64 tensors holding the unsigned value (torch's
uint32 supports few ops).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.bits import gf2_matmul, unpack_bits
from ..utils.consts import on

__all__ = ["CrcScheme", "CRC_NONE", "CRC_16", "CRC_32", "MAX_LEN", "crc_width_bytes",
           "crc_compute", "crc_compute_masked", "crc_append", "crc_check",
           "np_crc"]

MAX_LEN = 8192  # bytes

CRC_NONE = 0
CRC_16 = 1
CRC_32 = 2


class _CrcParams(NamedTuple):
    width: int
    poly: int
    init: int
    refin: bool
    refout: bool
    xorout: int


# CRC-16/ARC ("IBM"): the classic 0x8005 reflected CRC.
_CRC16 = _CrcParams(16, 0x8005, 0x0000, True, True, 0x0000)
# CRC-32 (IEEE 802.3 / zlib).
_CRC32 = _CrcParams(32, 0x04C11DB7, 0xFFFFFFFF, True, True, 0xFFFFFFFF)


def _bitrev(x: int, width: int) -> int:
    r = 0
    for _ in range(width):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _advance_bit(reg: int, bit: int, p: _CrcParams) -> int:
    mask = (1 << p.width) - 1
    top = (reg >> (p.width - 1)) & 1
    reg = (reg << 1) & mask
    if top ^ bit:
        reg ^= p.poly
    return reg


def _advance_byte(reg: int, byte: int, p: _CrcParams) -> int:
    order = range(8) if p.refin else range(7, -1, -1)
    for k in order:
        reg = _advance_bit(reg, (byte >> k) & 1, p)
    return reg


def _np_crc(data: bytes, p: _CrcParams) -> int:
    """Plain bit-serial reference implementation (host oracle)."""
    reg = p.init
    for b in data:
        reg = _advance_byte(reg, b, p)
    if p.refout:
        reg = _bitrev(reg, p.width)
    return reg ^ p.xorout


def _int_to_bits(x: int, width: int) -> np.ndarray:
    """MSB-first bit vector of an integer."""
    return np.array([(x >> (width - 1 - i)) & 1 for i in range(width)],
                    dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _build_tables(scheme: int):
    """Precompute (basis_desc [MAX_LEN*8, W], c0 [MAX_LEN+1, W]) bit tables.

    ``basis_desc[i]`` is the linear CRC response of a 1-bit at distance
    ``MAX_LEN*8 - 1 - i`` from the message end, so for an ``n``-byte message
    the slice ``basis_desc[-n*8:]`` aligns with its MSB-first unpacked bits.
    """
    if scheme == CRC_16:
        p = _CRC16
    elif scheme == CRC_32:
        p = _CRC32
    else:
        raise ValueError(f"unknown CRC scheme id {scheme}")
    w = p.width
    nbits = MAX_LEN * 8

    reg_k = [_advance_byte(0, 1 << k, p) for k in range(8)]

    basis = np.zeros((nbits, w), dtype=np.uint8)  # indexed by distance d
    for db in range(MAX_LEN):
        for k in range(8):
            d = db * 8 + k
            out = reg_k[k]
            if p.refout:
                out = _bitrev(out, w)
            basis[d] = _int_to_bits(out, w)
        for k in range(8):
            r = reg_k[k]
            for _ in range(8):
                r = _advance_bit(r, 0, p)
            reg_k[k] = r
    basis_desc = basis[::-1].copy()

    c0 = np.zeros((MAX_LEN + 1, w), dtype=np.uint8)
    reg = p.init
    for n in range(MAX_LEN + 1):
        out = _bitrev(reg, w) if p.refout else reg
        c0[n] = _int_to_bits(out ^ p.xorout, w)
        for _ in range(8):
            reg = _advance_bit(reg, 0, p)
    return basis_desc, c0


@functools.lru_cache(maxsize=None)
def _basis_tail(scheme: int, n: int) -> np.ndarray:
    """The last ``n*8`` rows of the basis (kept whole for :func:`on`)."""
    basis_desc, _ = _build_tables(scheme)
    return np.ascontiguousarray(basis_desc[basis_desc.shape[0] - n * 8:])


CrcScheme = int  # alias for readability in signatures


def crc_width_bytes(scheme: CrcScheme) -> int:
    return {CRC_NONE: 0, CRC_16: 2, CRC_32: 4}[scheme]


def _bits_to_uint(bits: torch.Tensor, width: int) -> torch.Tensor:
    weights = torch.tensor([1 << (width - 1 - i) for i in range(width)],
                           dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) * weights).sum(-1)


def crc_compute(scheme: int, data: torch.Tensor) -> torch.Tensor:
    """CRC of uint8 ``[..., n]`` -> int64 ``[...]`` (unsigned value)."""
    if scheme == CRC_NONE:
        return torch.zeros(data.shape[:-1], dtype=torch.int64,
                           device=data.device)
    _, c0 = _build_tables(scheme)
    n = data.shape[-1]
    if n > MAX_LEN:
        raise ValueError(f"message too long for CRC tables: {n} > {MAX_LEN}")
    lin = gf2_matmul(unpack_bits(data), on(_basis_tail(scheme, n),
                                            data.device))
    return _bits_to_uint(lin ^ on(c0, data.device)[n], c0.shape[-1])


def crc_compute_masked(scheme: int, data: torch.Tensor,
                       length: torch.Tensor) -> torch.Tensor:
    """CRC over the first ``length`` bytes of max-size buffers.

    ``data``: uint8 ``[..., n_max]``; ``length``: integer tensor ``[...]``
    with values <= n_max.  The message is right-aligned inside the buffer
    (leading zeros contribute nothing to the linear part) and the affine
    part is looked up by ``length``.
    """
    if scheme == CRC_NONE:
        return torch.zeros(data.shape[:-1], dtype=torch.int64,
                           device=data.device)
    _, c0 = _build_tables(scheme)
    n_max = data.shape[-1]
    length = length.to(torch.int64)
    idx = torch.arange(n_max, device=data.device)
    masked = torch.where(idx < length[..., None], data,
                         torch.zeros_like(data))
    # jnp.roll(masked, n_max - length): out[i] = masked[(i + length) % n_max]
    src = (idx + length[..., None]) % n_max
    aligned = torch.gather(masked, -1, src)
    lin = gf2_matmul(unpack_bits(aligned),
                     on(_basis_tail(scheme, n_max), data.device))
    return _bits_to_uint(lin ^ on(c0, data.device)[length], c0.shape[-1])


def crc_append(scheme: int, data: torch.Tensor) -> torch.Tensor:
    """Append the big-endian CRC bytes: uint8 ``[..., n]`` -> ``[..., n+w]``."""
    w = crc_width_bytes(scheme)
    if w == 0:
        return data
    c = crc_compute(scheme, data)
    shifts = torch.arange(w - 1, -1, -1, device=data.device) * 8
    crc_bytes = ((c[..., None] >> shifts) & 0xFF).to(torch.uint8)
    return torch.cat([data.to(torch.uint8), crc_bytes], dim=-1)


def crc_check(scheme: int, data_with_crc: torch.Tensor) -> torch.Tensor:
    """Validate a buffer produced by :func:`crc_append` -> bool ``[...]``."""
    w = crc_width_bytes(scheme)
    if w == 0:
        return torch.ones(data_with_crc.shape[:-1], dtype=torch.bool,
                          device=data_with_crc.device)
    got = crc_compute(scheme, data_with_crc[..., :-w])
    shifts = torch.arange(w - 1, -1, -1,
                          device=data_with_crc.device) * 8
    want = (data_with_crc[..., -w:].to(torch.int64) << shifts).sum(-1)
    return got == want


def np_crc(scheme: int, data: bytes) -> int:
    """Host-side bit-serial oracle."""
    return _np_crc(data, _CRC16 if scheme == CRC_16 else _CRC32)
