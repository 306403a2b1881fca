"""IQ stream sources/sinks (files with the UHD sample formats).

Port of ``liquid_usrp_tpu/io/streams.py`` (NumPy only, copied): ``.iq`` /
``.dat`` / ``.cfile`` raw interleaved float32 I/Q, ``.sc16`` interleaved
int16 I/Q (+-32767 full scale), ``.sc8`` interleaved int8 I/Q (+-127 full
scale), ``.npy`` NumPy complex64.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["write_iq", "read_iq", "iq_blocks"]


def write_iq(path: str, samples: np.ndarray) -> None:
    samples = np.asarray(samples, dtype=np.complex64)
    if path.endswith(".npy"):
        np.save(path, samples)
        return
    if path.endswith(".sc16"):
        inter = np.empty(samples.size * 2, dtype=np.float32)
        inter[0::2] = samples.real
        inter[1::2] = samples.imag
        np.clip(inter * 32767.0, -32768, 32767).astype(np.int16).tofile(path)
        return
    if path.endswith(".sc8"):
        inter = np.empty(samples.size * 2, dtype=np.float32)
        inter[0::2] = samples.real
        inter[1::2] = samples.imag
        np.clip(np.round(inter * 127.0), -127, 127).astype(np.int8) \
            .tofile(path)
        return
    inter = np.empty(samples.size * 2, dtype=np.float32)
    inter[0::2] = samples.real
    inter[1::2] = samples.imag
    inter.tofile(path)


def read_iq(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.complex64)
    if path.endswith(".sc16"):
        raw = np.fromfile(path, dtype=np.int16).astype(np.float32) / 32767.0
        if raw.size % 2:
            raw = raw[:-1]
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    if path.endswith(".sc8"):
        raw = np.fromfile(path, dtype=np.int8).astype(np.float32) / 127.0
        if raw.size % 2:
            raw = raw[:-1]
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    raw = np.fromfile(path, dtype=np.float32)
    if raw.size % 2:
        raw = raw[:-1]
    return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)


def iq_blocks(path: str, block_size: int):
    """Yield successive ``block_size`` chunks (zero-padded final block)."""
    data = read_iq(path)
    n = len(data)
    i = 0
    while i < n:
        blk = data[i:i + block_size]
        if len(blk) < block_size:
            blk = np.concatenate(
                [blk, np.zeros(block_size - len(blk), np.complex64)])
        yield blk
        i += block_size
