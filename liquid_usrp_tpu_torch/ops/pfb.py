"""Polyphase filterbank channelizer (analysis + synthesis).

Port of ``liquid_usrp_tpu/ops/pfb.py``.  The critically-sampled DFT
filterbank is (1) a reshape of the stream into ``[n_frames, M]`` frames,
(2) ``P`` multiply-adds along the frame axis per polyphase branch (the
prototype ``h[qM+p]`` as a ``[P, M]`` coefficient array) and (3) a batched
length-``M`` inverse FFT (``torch.fft``; cuFFT on the card).  The carried
state is the last ``P-1`` frames, so block boundaries are exact.

Channel semantics are unchanged: analysis output ``X_k[n] = sum_m h[m]
e^{+j 2pi k m / M} x[nM + M-1 - m]``, and synthesis places ``Y_k[n]`` at
frequency ``k/M``.

The prototype lives on the host in ``Pfbch.h_pol``; each function takes the
device copy ``h`` (``[P, M]`` float32, e.g. a module buffer) and falls back
to uploading ``h_pol`` when it is not given.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.consts import on
from ..utils.device import default_device
from .filter_design import pfb_channelizer_prototype

__all__ = ["Pfbch", "PfbchState", "pfbch_create", "pfbch_state",
           "pfb_analyze_block", "pfb_synthesize_block"]


class Pfbch(NamedTuple):
    M: int                 # number of channels (= frame size)
    P: int                 # taps per polyphase branch (2*m)
    h_pol: np.ndarray      # [P, M] float32, h_pol[q, p] = h[q*M + p]


class PfbchState(NamedTuple):
    frames: torch.Tensor   # [P-1, M] complex64 carried input/output frames


def pfbch_create(num_channels: int, m: int = 7, As: float = 60.0) -> Pfbch:
    M = num_channels
    h = pfb_channelizer_prototype(M, m, As)          # length 2*M*m
    P = 2 * m
    return Pfbch(M=M, P=P, h_pol=h.reshape(P, M).astype(np.float32))


def pfbch_state(ch: Pfbch, device=None) -> PfbchState:
    return PfbchState(frames=torch.zeros((ch.P - 1, ch.M),
                                         dtype=torch.complex64,
                                         device=default_device(device)))


def _branch_filter(ch: Pfbch, h: torch.Tensor, state_frames: torch.Tensor,
                   frames: torch.Tensor) -> torch.Tensor:
    """Per-branch FIR along the frame axis: ``u[n,p] = sum_q h[q,p] f[n-q,p]``."""
    ext = torch.cat([state_frames, frames], dim=0)        # [P-1+n, M]
    n = frames.shape[0]
    hc = h.to(frames.dtype)
    u = torch.zeros_like(frames)
    for q in range(ch.P):            # P is small (14-26): an FMA chain
        u = u + hc[q][None, :] * ext[ch.P - 1 - q: ch.P - 1 - q + n]
    return u


def pfb_analyze_block(ch: Pfbch, state: PfbchState, x: torch.Tensor,
                      h: torch.Tensor | None = None):
    """Analyze ``x[n_frames*M]`` -> ``(state', X[n_frames, M])`` channels."""
    if h is None:
        h = on(ch.h_pol, x.device)
    M = ch.M
    n = x.shape[-1] // M
    rev = x.reshape(n, M).flip(-1)            # rev[n, p] = x[nM + M-1-p]
    u = _branch_filter(ch, h, state.frames, rev)
    X = M * torch.fft.ifft(u, dim=-1)
    new = torch.cat([state.frames, rev], dim=0)[-(ch.P - 1):]
    return PfbchState(frames=new), X


def pfb_synthesize_block(ch: Pfbch, state: PfbchState, Y: torch.Tensor,
                         h: torch.Tensor | None = None):
    """Synthesize channel frames ``Y[n_frames, M]`` -> ``(state', y[n*M])``."""
    if h is None:
        h = on(ch.h_pol, Y.device)
    v = ch.M * torch.fft.ifft(Y.to(torch.complex64), dim=-1)   # v[n, p]
    out = _branch_filter(ch, h, state.frames, v)
    new = torch.cat([state.frames, v], dim=0)[-(ch.P - 1):]
    return PfbchState(frames=new), out.reshape(-1)
