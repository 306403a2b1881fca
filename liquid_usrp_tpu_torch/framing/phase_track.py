"""Blockwise carrier-phase tracking for pseudo-BPSK symbol streams.

Port of ``liquid_usrp_tpu/framing/phase_track.py`` with a leading batch
axis (one call serves every candidate of a dispatch, where JAX ``vmap``s).
Stage 1 (Viterbi & Viterbi): squaring removes the +-1 data signs, so each
``seg``-symbol segment gives a phase mod pi, unwrapped across segments.
Stages 2+ (data-aided): decisions from the previous trajectory, with the
caller's known signs over pilot/template spans, re-estimate each segment's
phase coherently.  The trajectory is interpolated linearly between segment
centers.  The unwrap is a floor modulo (``torch.remainder``, as
``jnp.mod``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["track_phase_bpsk"]


def _cis(x: torch.Tensor) -> torch.Tensor:
    """``exp(1j * x)`` for real ``x`` (complex64)."""
    return torch.polar(torch.ones_like(x), x)


def _unwrap_pi(ph: torch.Tensor) -> torch.Tensor:
    """Segment phases ``[..., n_seg]`` unwrapped modulo pi."""
    dph = torch.remainder(ph[..., 1:] - ph[..., :-1] + np.pi / 2,
                          np.pi) - np.pi / 2
    return torch.cat([ph[..., :1], ph[..., :1] + torch.cumsum(dph, -1)], -1)


def track_phase_bpsk(y: torch.Tensor, sgn_known: torch.Tensor,
                     seg: int = 32, n_iter: int = 2) -> torch.Tensor:
    """Phase trajectory ``phi [..., n]`` for pseudo-BPSK streams ``y [...,
    n]`` (+-1 signs times a slowly drifting carrier); ``sgn_known [..., n]``
    holds the known sign (+-1) over template/pilot spans and 0 elsewhere.
    The first segment must hold known signs to anchor the absolute phase.
    Callers apply ``y * exp(-1j * phi)``."""
    lead, n = y.shape[:-1], y.shape[-1]
    n_seg = -(-n // seg)
    npad = n_seg * seg
    ypad = torch.nn.functional.pad(y, (0, npad - n))
    spad = torch.nn.functional.pad(
        sgn_known.to(torch.float32).expand(*lead, n), (0, npad - n))
    valid = torch.arange(npad, device=y.device) < n
    known = spad != 0.0

    # pass 1: V&V seed
    y2 = (ypad * ypad).reshape(*lead, n_seg, seg).sum(-1)
    phu = _unwrap_pi(0.5 * torch.angle(y2))

    # passes 2..: data-aided refinement
    for _ in range(n_iter):
        yc = ypad * _cis(-phu.repeat_interleave(seg, dim=-1))
        r = yc.real
        s_hat = torch.where(known, spad, torch.where(
            r >= 0, torch.ones_like(r), -torch.ones_like(r)))
        s_hat = torch.where(valid, s_hat, torch.zeros_like(s_hat))
        u2 = (ypad * s_hat).reshape(*lead, n_seg, seg).sum(-1)
        phu = _unwrap_pi(torch.angle(u2))

    if n_seg == 1:
        return phu[..., :1].expand(*lead, n)
    # linear interpolation between segment centers
    ctr = (seg - 1) / 2.0
    fi = (torch.arange(n, dtype=torch.float32, device=y.device) - ctr) / seg
    i0 = torch.clamp(torch.floor(fi).to(torch.int64), 0, n_seg - 2)
    fr = torch.clamp(fi - i0.to(torch.float32), 0.0, 1.0)
    return phu[..., i0] * (1 - fr) + phu[..., i0 + 1] * fr
