"""Streaming FIR filters over IQ blocks: plain, interpolating, decimating.

Port of ``liquid_usrp_tpu/ops/fir.py``.  Each operator is ``step(state,
block) -> (state', out)``; the carried state is the filter memory (the last
inputs of the block), so a stream gives the same output whatever its block
size.  Blocks run along the last axis.  A complex signal with real taps is
filtered as two real planes through ``conv1d`` (JAX's ``jnp.convolve``), and
the interpolator's per-phase filters are one float32 matmul over the
windows of the undecimated input (JAX's ``windows @ phases``).  Taps are a
NumPy array or a float32 tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import default_device

__all__ = [
    "FirState", "fir_init", "firinterp_init", "fir_block",
    "firinterp_block", "firdecim_block",
]


class FirState(NamedTuple):
    tail: torch.Tensor  # last (L-1) inputs, complex64 [..., L-1]


def fir_init(ntaps: int, dtype=torch.complex64, device=None) -> FirState:
    return FirState(tail=torch.zeros(ntaps - 1, dtype=dtype,
                                     device=default_device(device)))


def firinterp_init(ntaps: int, k: int, dtype=torch.complex64,
                   device=None) -> FirState:
    P = -(-ntaps // k)  # taps per polyphase branch
    return FirState(tail=torch.zeros(P - 1, dtype=dtype,
                                     device=default_device(device)))


def _taps(taps, device) -> torch.Tensor:
    if isinstance(taps, np.ndarray):
        from ..utils.consts import on
        return on(taps, device, torch.float32)
    return taps.to(device=device, dtype=torch.float32)


def _conv_valid(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``y[n] = sum_t h[t] x[n + L - 1 - t]`` along the last axis of a
    pre-extended ``x`` (real taps ``h [L]``; complex ``x`` as two planes)."""
    L = h.shape[-1]
    w = h.flip(-1).reshape(1, 1, L)         # conv1d correlates
    lead, n = x.shape[:-1], x.shape[-1]
    if x.is_complex():
        planes = torch.stack([x.real, x.imag], dim=-2).reshape(-1, 1, n)
        y = torch.nn.functional.conv1d(planes, w).reshape(*lead, 2, -1)
        return torch.complex(y[..., 0, :], y[..., 1, :])
    return torch.nn.functional.conv1d(x.reshape(-1, 1, n), w).reshape(
        *lead, -1)


def fir_block(taps, state: FirState, x: torch.Tensor):
    """Causal FIR over a block: ``y[n] = sum_t h[t] x[n - t]``.

    ``x``: ``[..., N]``; returns ``(state', y[..., N])``."""
    h = _taps(taps, x.device)
    ext = torch.cat([state.tail, x], dim=-1)
    y = _conv_valid(ext, h)
    n_keep = h.shape[0] - 1
    return FirState(tail=ext[..., ext.shape[-1] - n_keep:]), y


def firinterp_block(taps, k: int, state: FirState, x: torch.Tensor):
    """Polyphase k-fold interpolating FIR: ``[N] -> [N*k]``.

    ``y[n*k + p] = sum_m h[p + k*m] x[n - m]``; the carried state stores
    ``P-1`` input samples where ``P = ceil(L/k)``."""
    h = _taps(taps, x.device)
    L = h.shape[0]
    P = -(-L // k)
    phases = torch.nn.functional.pad(h, (0, P * k - L)).reshape(P, k)
    ext = torch.cat([state.tail, x.to(state.tail.dtype)])   # [P-1 + N]
    n = x.shape[-1]
    # windows[i, c, m] = plane c of x[i - m] = ext[i + P - 1 - m]
    windows = torch.view_as_real(ext).unfold(0, P, 1).flip(-1)   # [N, 2, P]
    y = windows @ phases                                         # [N, 2, k]
    y = torch.complex(y[:, 0], y[:, 1]).reshape(n * k)
    return FirState(tail=ext[ext.shape[0] - (P - 1):]), y


def firdecim_block(taps, k: int, state: FirState, x: torch.Tensor):
    """k-fold decimating FIR: ``[N] -> [N//k]`` (N a multiple of k),
    ``y[n] = sum_t h[t] x[n*k + k - 1 - t]`` (newest-sample aligned)."""
    state, full = fir_block(taps, state, x)
    return state, full[..., k - 1::k]
