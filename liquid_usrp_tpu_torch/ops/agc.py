"""Automatic gain control with settable loop bandwidth.

Port of ``liquid_usrp_tpu/ops/agc.py`` (``agc_crcf`` as the receive-power
meter app uses it).  The loop is a first-order IIR on the instantaneous
amplitude, ``L[n] = (1-a) L[n-1] + a |x[n]|``: a linear recurrence, so a
whole block runs as a log-depth scan over ``(m, b)`` affine maps instead
of a per-sample loop.  JAX runs ``lax.associative_scan``; torch has no
public associative scan, so :func:`_affine_scan` is a Hillis-Steele scan
in ``ceil(log2 n)`` strided steps.  A closed form through a cumulative
product of ``1-a`` is no substitute: ``0.99**n`` underflows float32 past
n of about 10,300 and the division by it overflows.  The scan combines in
another order than XLA's, so levels agree with the JAX package's within a
relative 1e-5 (the tests' tolerance).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import default_device

__all__ = ["AgcState", "agc_init", "agc_block"]


class AgcState(NamedTuple):
    level: torch.Tensor   # scalar float32: smoothed input level (linear)
    alpha: torch.Tensor   # scalar float32: loop smoothing factor


def agc_init(bandwidth: float = 0.01, initial_level: float = 1.0,
             device=None) -> AgcState:
    dev = default_device(device)
    return AgcState(
        level=torch.tensor(initial_level, dtype=torch.float32, device=dev),
        alpha=torch.tensor(bandwidth, dtype=torch.float32, device=dev))


def _affine_scan(m: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the maps ``L -> m[i] L + b[i]`` along the last
    axis: ``(M[i], B[i])`` with ``M[i] L + B[i]`` the composition of maps
    ``0..i`` applied in order (Hillis-Steele: after the step of stride d,
    element i holds the composition of ``max(0, i-2d+1)..i``)."""
    n = m.shape[-1]
    d = 1
    while d < n:
        m_prev, b_prev = m[..., :n - d], b[..., :n - d]
        m_cur, b_cur = m[..., d:], b[..., d:]
        b = torch.cat([b[..., :d], m_cur * b_prev + b_cur], dim=-1)
        m = torch.cat([m[..., :d], m_prev * m_cur], dim=-1)
        d *= 2
    return m, b


def agc_block(state: AgcState, x: torch.Tensor):
    """Track and normalize a block.

    Returns ``(state', y, level[N], rssi_db[N])`` where ``y = x / level`` is
    the unity-target output and ``rssi_db = 20 log10(level)``."""
    a = state.alpha
    amp = torch.clamp(torch.abs(x), min=1e-10)
    ms = (1.0 - a).expand(amp.shape).to(torch.float32)
    m_acc, b_acc = _affine_scan(ms, a * amp)
    level = m_acc * state.level + b_acc
    y = x / torch.clamp(level, min=1e-12).to(x.dtype)
    rssi = 20.0 * torch.log10(torch.clamp(level, min=1e-12))
    return state._replace(level=level[-1]), y, level, rssi
