"""Resamplers: half-band 2x, arbitrary polyphase, and multi-stage.

Port of ``liquid_usrp_tpu/ops/resamp.py`` (``resamp2_crcf``,
``resamp_crcf`` and ``msresamp_crcf`` semantics).  The arbitrary resampler
snaps its rate to a rational and computes the whole output timing grid of a
block in exact int32 arithmetic: output slot ``j`` samples the input at
``t_j = i0 + j*a + (num0 + j*b)/q``, and its value is the input window at
``floor(t_j)`` dotted with the polyphase filter at the fractional phase,
linearly interpolated between adjacent phase filters.  Blocks have a static
``max_out`` slots with a validity mask and a count; the carried state (the
delay-line tail and the integer timing) makes results block-size invariant.

Only the general (gather) form is ported; JAX's rational fast path, a
TPU-only form of the same outputs, is not (ROADMAP, "Do not port").
``msresamp`` runs its half-band stages first and the arbitrary stage last,
so only the last stage produces masked output.
"""
from __future__ import annotations

from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from ..utils.consts import on
from ..utils.device import default_device
from .filter_design import firdes_kaiser, halfband_kaiser
from .fir import FirState, fir_block, fir_init, firinterp_block, \
    firinterp_init

__all__ = [
    "Resamp2", "resamp2_create", "resamp2_state", "resamp2_decim_state",
    "resamp2_interp_block", "resamp2_decim_block",
    "Resamp", "ResampState", "resamp_create", "resamp_state", "resamp_block",
    "resamp_set_rate", "resamp_rescale_state", "resamp_max_out",
    "Msresamp", "MsresampState", "msresamp_create", "msresamp_state",
    "msresamp_max_out", "msresamp_block", "compact_masked",
]


# ---------------------------------------------------------------------------
# half-band 2x (resamp2 semantics)
# ---------------------------------------------------------------------------

class Resamp2(NamedTuple):
    taps: np.ndarray   # [4m+1] float32 half-band


def resamp2_create(m: int = 7, As: float = 60.0) -> Resamp2:
    return Resamp2(taps=halfband_kaiser(m, As).astype(np.float32))


def resamp2_state(r2: Resamp2, device=None) -> FirState:
    return firinterp_init(r2.taps.shape[0], 2, device=device)


def resamp2_decim_state(r2: Resamp2, device=None) -> FirState:
    return fir_init(r2.taps.shape[0], device=device)


def resamp2_interp_block(r2: Resamp2, state: FirState, x: torch.Tensor):
    """2x interpolation: ``[N] -> [2N]`` (unit passband gain)."""
    return firinterp_block(on(r2.taps, x.device) * 2.0, 2, state, x)


def resamp2_decim_block(r2: Resamp2, state: FirState, x: torch.Tensor):
    """2x decimation: ``[N] -> [N/2]`` (N even), decimation phase 0
    (``y[n] = filtered[2n]``), so an interp -> decim cascade has an integer
    group delay."""
    state, full = fir_block(r2.taps, state, x)
    return state, full[..., ::2]


# ---------------------------------------------------------------------------
# arbitrary polyphase resampler (resamp semantics)
# ---------------------------------------------------------------------------

class Resamp(NamedTuple):
    pfb: np.ndarray       # [npfb + 1, P] float32 (extra row for lerp wrap)
    npfb: int
    P: int                # taps per phase
    # exact rational timing: input advances a + b/q per output sample
    a: int
    b: int
    q: int
    rate: float           # output/input rate (as snapped)


class ResampState(NamedTuple):
    tail: torch.Tensor    # [P-1] complex64 input delay line
    i0: torch.Tensor      # int32: input index of next output (vs block start)
    num0: torch.Tensor    # int32: fractional numerator in [0, q)


def _stride(rate: float, max_den: int):
    frac = Fraction(rate).limit_denominator(max_den)
    # input stride per output = 1/rate = q/p as a fraction
    stride = Fraction(frac.denominator, frac.numerator)
    return (stride.numerator // stride.denominator,
            stride.numerator % stride.denominator, stride.denominator,
            float(frac))


def resamp_create(rate: float, m: int = 7, fc: float = 0.45,
                  As: float = 60.0, npfb: int = 64,
                  max_den: int = 4096) -> Resamp:
    """Arbitrary-rate polyphase resampler: ``rate`` output/input (snapped
    to a rational with denominator <= ``max_den``), ``P = 2m+1`` taps per
    phase, cutoff ``fc`` relative to the narrower Nyquist band."""
    P = 2 * m + 1
    L = npfb * P
    cutoff = fc * min(1.0, rate) / npfb
    proto = firdes_kaiser(L, cutoff, As)
    # normalize so each phase sums to ~1 (unit passband gain)
    proto = proto / np.sum(proto) * npfb
    pfb = proto.reshape(P, npfb).T  # pfb[phase, tap] = proto[phase + npfb*tap]
    # lerp wrap row = the phase-0 subfilter advanced one tap
    wrap = np.concatenate([pfb[0, 1:], [0.0]])
    pfb = np.concatenate([pfb, wrap[None, :]], axis=0)
    a, b, q, snapped = _stride(rate, max_den)
    return Resamp(pfb=pfb.astype(np.float32), npfb=npfb, P=P, a=a, b=b, q=q,
                  rate=snapped)


def resamp_state(rs: Resamp, device=None) -> ResampState:
    dev = default_device(device)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return ResampState(tail=torch.zeros(rs.P - 1, dtype=torch.complex64,
                                        device=dev), i0=zero, num0=zero)


def resamp_set_rate(rs: Resamp, rate: float, max_den: int = 4096) -> Resamp:
    """Runtime rate change: only the timing changes, the filter bank is
    kept (as liquid's ``resamp_crcf_set_rate``)."""
    a, b, q, snapped = _stride(rate, max_den)
    return rs._replace(a=a, b=b, q=q, rate=snapped)


def resamp_rescale_state(rs_old: Resamp, rs_new: Resamp,
                         state: ResampState) -> ResampState:
    """Carry streaming state across :func:`resamp_set_rate`: the delay line
    transfers directly; the fractional timing numerator is re-expressed on
    the new denominator grid (nearest exact phase)."""
    num = torch.round(state.num0.to(torch.float32) *
                      (rs_new.q / rs_old.q)).to(torch.int32)
    return state._replace(num0=torch.clamp(num, 0, rs_new.q - 1))


def resamp_max_out(rs: Resamp, n_in: int) -> int:
    return int(np.ceil(n_in * rs.rate)) + 2


def resamp_block(rs: Resamp, state: ResampState, x: torch.Tensor):
    """Resample a block: ``[N] -> (state', y[max_out], valid[max_out],
    count)``; ``count`` is an int32 tensor.  The timing is int32, as in
    JAX: a block whose slot numerators could pass 2^31 raises."""
    n = x.shape[-1]
    max_out = resamp_max_out(rs, n)
    if max_out * rs.b + rs.q >= 2 ** 31:
        raise ValueError(
            f"int32 timing overflow: block of {n} with rate "
            f"{rs.rate} (b={rs.b}, q={rs.q}); use smaller blocks or a "
            "coarser rational rate")
    dev = x.device
    ext = torch.cat([state.tail, x.to(torch.complex64)])    # [P-1 + N]

    j = torch.arange(max_out, dtype=torch.int32, device=dev)
    num = state.num0 + j * rs.b                     # < q + max_out*b
    i = state.i0 + j * rs.a + num // rs.q           # input index of output j
    frac = (num % rs.q).to(torch.float32) / rs.q    # [0, 1)
    valid = i < n

    # window for output j: x[i - P + 1 .. i] = ext[i .. i + P - 1],
    # reversed so tap p multiplies x[i - p] (convolution orientation);
    # slots past the block read the last window (masked below)
    i_safe = torch.clamp(i.to(torch.int64), 0, n - 1)
    win = i_safe[:, None] + torch.arange(rs.P, device=dev)
    windows = ext[win].flip(-1)                     # [max_out, P]

    ph = frac * rs.npfb
    ph_lo = torch.floor(ph).to(torch.int64)
    w = (ph - ph_lo.to(torch.float32))[:, None]
    pfb = on(rs.pfb, dev)
    h = pfb[ph_lo] * (1.0 - w) + pfb[ph_lo + 1] * w  # [max_out, P]
    y = (windows * h).sum(-1)
    y = torch.where(valid, y, torch.zeros_like(y))

    count = valid.sum(dtype=torch.int32)
    # state at the first invalid slot
    num_c = state.num0 + count * rs.b
    i_next = state.i0 + count * rs.a + num_c // rs.q
    new_state = ResampState(tail=ext[ext.shape[0] - (rs.P - 1):],
                            i0=(i_next - n).to(torch.int32),
                            num0=(num_c % rs.q).to(torch.int32))
    return new_state, y, valid, count


# ---------------------------------------------------------------------------
# multi-stage resampler (msresamp semantics)
# ---------------------------------------------------------------------------

class Msresamp(NamedTuple):
    num_halfband: int     # half-band stages (decim if rate<1, interp if >1)
    is_interp: bool
    hb: Resamp2
    arb: Resamp


class MsresampState(NamedTuple):
    hb_states: tuple      # FirState per half-band stage
    arb_state: ResampState


def msresamp_create(rate: float, As: float = 60.0) -> Msresamp:
    """Multi-stage arbitrary resampler: half-band stages and one arbitrary
    stage at a rate in (0.5, 1] (``msresamp_crcf``: any total rate, ``As``
    dB stopband)."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    s = 0
    if rate < 1.0:
        r = rate
        while r <= 0.5:
            r *= 2.0
            s += 1
        return Msresamp(s, False, resamp2_create(7, As),
                        resamp_create(r, 7, 0.45, As))
    r = rate
    while r > 2.0:
        r /= 2.0
        s += 1
    # arb stage in (0.5, 1], then s or s+1 interp stages
    if r > 1.0:
        r /= 2.0
        s += 1
    return Msresamp(s, True, resamp2_create(7, As),
                    resamp_create(r, 7, 0.45, As))


def msresamp_state(ms: Msresamp, device=None) -> MsresampState:
    mk = resamp2_state if ms.is_interp else resamp2_decim_state
    return MsresampState(
        hb_states=tuple(mk(ms.hb, device) for _ in range(ms.num_halfband)),
        arb_state=resamp_state(ms.arb, device))


def msresamp_max_out(ms: Msresamp, n_in: int) -> int:
    if ms.is_interp:
        n = n_in * (2 ** ms.num_halfband)
    else:
        n = n_in // (2 ** ms.num_halfband)
    return resamp_max_out(ms.arb, n)


def msresamp_block(ms: Msresamp, state: MsresampState, x: torch.Tensor):
    """``[N] -> (state', y[max_out], valid, count)``; for decimation N must
    be divisible by ``2**num_halfband``.  The arbitrary stage runs last, so
    the fixed-rate stages see the gapless stream (block-size invariance)."""
    hb_states = []
    cur = x
    for st in state.hb_states:
        if ms.is_interp:
            st, cur = resamp2_interp_block(ms.hb, st, cur)
        else:
            st, cur = resamp2_decim_block(ms.hb, st, cur)
        hb_states.append(st)
    arb_state, y, valid, count = resamp_block(ms.arb, state.arb_state, cur)
    return MsresampState(tuple(hb_states), arb_state), y, valid, count


def compact_masked(y: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Move valid samples to the front (stable), zero-fill the rest."""
    idx = torch.cumsum(valid.to(torch.int64), 0) - 1
    tgt = torch.where(valid, idx, torch.full_like(idx, y.shape[0] - 1))
    out = torch.zeros_like(y)
    return out.index_add_(0, tgt, torch.where(valid, y, torch.zeros_like(y)))
