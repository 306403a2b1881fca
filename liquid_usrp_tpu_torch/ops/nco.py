"""Numerically-controlled oscillator: block-vectorized complex mixing.

Port of ``liquid_usrp_tpu/ops/nco.py``.  Phase is a fixed-point turn
accumulator (1 turn = 2^32): ``phase[i] = phase0 + freq * i`` in wrapping
32-bit arithmetic is exact modular math, so every block chopping mixes with
bit-identical phases.  torch's uint32 supports few operations, so the port
holds the uint32 values in int64 tensors and wraps with ``& 0xFFFFFFFF``
(``freq * i`` stays below 2^63 for any block shorter than 2^31 samples).
The uint32 -> float32 conversion before ``* _TO_RAD`` rounds to nearest,
as the JAX cast does, so the phase ramp matches it bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import default_device

__all__ = ["NcoState", "nco_init", "nco_init_at", "nco_phase_ramp",
           "nco_mix_block", "freq_to_u32"]

_TWO_PI = 2.0 * np.pi
_TURN = float(2.0 ** 32)          # uint32 units per turn
_TO_RAD = np.float32(_TWO_PI / _TURN)
_MASK = 0xFFFFFFFF


def freq_to_u32(freq_rad: float) -> int:
    """Quantize radians/sample to the uint32 turn grid (host-side)."""
    turns = float(freq_rad) / _TWO_PI
    return int(round(turns * _TURN)) % (1 << 32)


class NcoState(NamedTuple):
    phase: torch.Tensor  # scalar int64 holding a uint32, 2^-32 turns
    freq: torch.Tensor   # scalar int64 holding a uint32, 2^-32 turns/sample


def nco_init(freq_rad: float, phase: float = 0.0, device=None) -> NcoState:
    ph = int(round(phase / _TWO_PI * _TURN)) % (1 << 32)
    device = default_device(device)
    return NcoState(
        phase=torch.tensor(ph, dtype=torch.int64, device=device),
        freq=torch.tensor(freq_to_u32(freq_rad), dtype=torch.int64,
                          device=device))


def nco_init_at(freq_rad: float, index: int, device=None) -> NcoState:
    """NCO state positioned at absolute sample ``index``: the phase is
    ``freq * (index mod 2^32)`` reduced mod 2^32, exact at any stream
    offset.  The sharded builders compute each rank's global index on the
    host, so the arithmetic is on Python ints."""
    f = freq_to_u32(freq_rad)
    device = default_device(device)
    return NcoState(
        phase=torch.tensor(f * (int(index) & _MASK) & _MASK,
                           dtype=torch.int64, device=device),
        freq=torch.tensor(f, dtype=torch.int64, device=device))


def nco_phase_ramp(state: NcoState, n: int):
    """Radian phases (float32) for the next ``n`` samples and the advanced
    state."""
    idx = torch.arange(n, dtype=torch.int64, device=state.phase.device)
    ph_u32 = (state.phase + state.freq * idx) & _MASK
    new_phase = (state.phase + state.freq * (n % (1 << 32))) & _MASK
    ph = ph_u32.to(torch.float32) * float(_TO_RAD)
    return ph, state._replace(phase=new_phase)


def nco_mix_block(state: NcoState, x: torch.Tensor, up: bool = True):
    """Mix a complex block up (+f) or down (-f): ``(state, x) -> (state', y)``."""
    ph, new_state = nco_phase_ramp(state, x.shape[-1])
    rot = torch.polar(torch.ones_like(ph), ph if up else -ph)
    return new_state, x * rot
