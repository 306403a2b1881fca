"""Single-carrier flexframe synchronizer (RX) — batched block dataflow.

Port of ``liquid_usrp_tpu/framing/flexframe_sync.py`` (``flexframesync``
and ``framesync64``).  Same block architecture as the OFDM sync: each
extended window (``tail ++ block``) goes through

1. one FFT-domain front end: a single forward FFT feeds the RRC matched
   filter and both preamble-half correlators, the energy normalizer is a
   comb moving sum, and non-max suppression with a top-k picks the
   candidate preamble starts;
2. a decode batched over a leading candidate axis (where JAX ``vmap``s):
   CFO from the split-preamble phase, fractional timing by a parabolic fit
   of the metric peak, windowed-sinc fractional-delay symbol sampling,
   complex gain from the preamble, header phase tracking, a pilot-anchored
   phase line over the payload, then the shared header/payload codec.

Each candidate reads its own window's matched-filter output and metric by
(row, offset) index, so the batched dispatch copies nothing per candidate
(JAX gathers ``mf[blk_of]``, one window copy per candidate).  Every
gather clamps its index into range, as a JAX gather does.  The decode gate
is a host ``if`` on ``detected.any()`` where JAX has a ``lax.cond``.
Results are fixed-shape with ``detected``/valid masks; unmasked fields of
undetected rows are unspecified, as in JAX.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import modem as modem_mod
from ..ops.corr import comb_moving_sum, comb_rev_freq_np, find_candidates, \
    next_pow2
from ..ops.iqfmt import iq_from_any
from ..utils.consts import on
from ..utils.device import default_device
from . import payload as payload_codec
from .flexframe import (FLEX_HEADER_USER, FlexParams, PILOT_SPACING,
                        PREAMBLE_SYMS, make_flex_params, slots_layout)
from .payload import EXPANSION as _EXPANSION, HEADER_BPS, HEADER_MOD
from .phase_track import _cis, track_phase_bpsk

__all__ = ["FlexSync", "FlexSyncState", "FlexResults", "make_flex_sync",
           "flex_sync_init", "flex_sync_block", "make_flex_sync_step",
           "flex_sync_blocks_batched"]

_FD_NPFB = 64      # fractional-delay phases
_FD_SEMI = 4       # taps = 2*semi


class FlexSync(NamedTuple):
    params: FlexParams
    block_size: int
    max_payload: int
    max_frames: int
    threshold: float
    overlap: int
    max_slots: int             # payload section slot budget
    dec_max: int
    enc_max: int
    fecs: tuple = payload_codec.PAYLOAD_FECS
    soft: bool = False         # soft-decision LLRs into Golay and conv FEC
    header_user: int = FLEX_HEADER_USER   # user-header bytes (static)


class FlexSyncState(NamedTuple):
    tail: torch.Tensor         # [overlap] complex64 raw samples
    base: torch.Tensor         # int32 stream index of tail[0] (wraps at 2^31)


class FlexResults(NamedTuple):
    """Fixed-shape per-block results; trailing candidate dim = max_frames."""
    detected: torch.Tensor
    header_valid: torch.Tensor
    payload_valid: torch.Tensor
    header: torch.Tensor        # [..., header_user] uint8
    payload: torch.Tensor       # [..., max_payload] uint8
    payload_len: torch.Tensor
    mod: torch.Tensor
    fec0: torch.Tensor
    fec1: torch.Tensor
    check: torch.Tensor
    rssi: torch.Tensor
    evm: torch.Tensor
    cfo: torch.Tensor
    t_start: torch.Tensor


def make_flex_sync(params: FlexParams, block_size: int = 16384,
                   max_payload: int = 2048, max_frames: int = 8,
                   threshold: float = 0.5, enable_conv: bool = False,
                   soft: bool = False,
                   expansion: int = _EXPANSION,
                   header_user: int = FLEX_HEADER_USER) -> FlexSync:
    if expansion < 1:
        raise ValueError(f"expansion must be >= 1 (got {expansion})")
    dec_max = max_payload + 4
    enc_max = expansion * dec_max   # see payload.check_budget
    # +1 point: DPSK payloads lead with a phase-reference point
    max_data = enc_max * 8 + 1                  # bps >= 1
    max_slots = max_data + -(-max_data // (PILOT_SPACING - 1))
    n_syms = PREAMBLE_SYMS + payload_codec.header_syms(header_user) \
        + max_slots
    max_frame = n_syms * params.k + 4 * params.m * params.k
    # overlap margin beyond the frame: detect-region inset, matched-filter
    # group delay and fractional-delay interpolation reads
    return FlexSync(params=params, block_size=block_size,
                    max_payload=max_payload, max_frames=max_frames,
                    threshold=threshold,
                    overlap=max_frame + 32 * params.k + 32,
                    max_slots=max_slots, dec_max=dec_max, enc_max=enc_max,
                    fecs=(payload_codec.PAYLOAD_FECS_FULL if enable_conv
                          else payload_codec.PAYLOAD_FECS), soft=bool(soft),
                    header_user=header_user)


def flex_sync_init(sync: FlexSync, device=None) -> FlexSyncState:
    dev = default_device(device)
    return FlexSyncState(
        tail=torch.zeros(sync.overlap, dtype=torch.complex64, device=dev),
        base=torch.tensor(-sync.overlap, dtype=torch.int32, device=dev))


@functools.lru_cache(maxsize=None)
def _fd_bank() -> np.ndarray:
    """Windowed-sinc fractional-delay bank ``[npfb+1, 8]``: row p delays
    by ``p/npfb`` samples (row npfb duplicates row 0 shifted, for lerp)."""
    t = np.arange(-_FD_SEMI, _FD_SEMI, dtype=np.float64)  # 8 taps
    rows = []
    for p in range(_FD_NPFB + 1):
        mu = p / _FD_NPFB
        h = np.sinc(t + 1 - mu) * np.kaiser(2 * _FD_SEMI, 7.0)
        rows.append(h / h.sum())
    return np.asarray(rows, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _fe_freq_np(k: int, m: int, beta: float, nfft: int):
    """Host-precomputed frequency responses of the front-end FFT chain:
    ``(H_mf, G1, G2)``, the RRC matched filter and the two k-dilated
    preamble-half correlators."""
    p = make_flex_params(k, m, beta)
    half = PREAMBLE_SYMS // 2
    H = np.fft.fft(p.taps.astype(np.complex64), nfft).astype(np.complex64)
    G1 = comb_rev_freq_np(p.preamble[:half], k, nfft)
    G2 = comb_rev_freq_np(p.preamble[half:], k, nfft)
    return H, G1, G2


@functools.lru_cache(maxsize=None)
def _payload_layout(k: int, m: int, beta: float, max_slots: int):
    """Host tables of the payload section: data and pilot positions, each
    data slot's pilot segment, and the pilot reference by ordinal."""
    pilot_pn = make_flex_params(k, m, beta).pilot_pn
    data_pos, pilot_pos = slots_layout(max_slots)
    pil_ref = pilot_pn[np.arange(len(pilot_pos)) %
                       len(pilot_pn)].astype(np.complex64)
    seg = (data_pos // PILOT_SPACING).astype(np.float32)
    return data_pos, pilot_pos, pil_ref, seg


def _find_candidates(sync: FlexSync, metric: torch.Tensor):
    """``(detected, locs)`` ``[..., max_frames]``: NMS top-k in the detect
    region ``[win, block_size + win)``, ``win = k * PREAMBLE_SYMS / 2``."""
    win = sync.params.k * PREAMBLE_SYMS // 2
    vals, locs = find_candidates(metric, win, sync.block_size,
                                 sync.threshold, sync.max_frames)
    return vals > 0, locs


def _row_gather(src: torch.Tensor, row_of: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """``src[row_of[r], idx[r, ...]]`` per candidate ``r`` from ``src
    [rows, n]``, with ``idx`` clamped into ``[0, n)`` (JAX's gather
    clamp)."""
    n = src.shape[-1]
    idx = torch.clamp(idx.to(torch.int64), 0, n - 1)
    base = row_of.to(torch.int64).reshape(-1, *([1] * (idx.dim() - 1))) * n
    return src.reshape(-1)[base + idx]


def _decode_candidate(sync: FlexSync, mf: torch.Tensor, metric: torch.Tensor,
                      row_of: torch.Tensor, n0: torch.Tensor,
                      c1: torch.Tensor, c2: torch.Tensor):
    """Decode candidates ``r`` at offsets ``n0 [R]`` of window ``row_of[r]``
    of ``mf [rows, L]`` / ``metric [rows, n_metric]``, with their
    preamble-half correlations ``c1, c2 [R]``.  Returns (user, data points,
    plen, mod, f0, f1, check, hvalid, rssi, hevm, cfo), each ``[R, ...]``."""
    p = sync.params
    k = p.k
    half = PREAMBLE_SYMS // 2
    dev = mf.device
    L = mf.shape[-1]
    n0 = n0.to(torch.int64)

    # CFO from split preamble halves (phase advance over half*k samples)
    cfo = torch.angle(c2 * torch.conj(c1)) / (half * k)

    # fractional timing: parabolic fit on the metric around the peak
    m_m1 = _row_gather(metric, row_of, n0 - 1)
    m_0 = _row_gather(metric, row_of, n0)
    m_p1 = _row_gather(metric, row_of, n0 + 1)
    denom = m_m1 - 2 * m_0 + m_p1
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (m_m1 - m_p1) / denom,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)

    # symbol sample positions: preamble starts at n0 (+delta fractional)
    hdr_syms = payload_codec.header_syms(sync.header_user)
    n_syms = PREAMBLE_SYMS + hdr_syms + sync.max_slots
    n0f = n0.to(torch.float32)
    pos = (n0f + delta)[:, None] + k * torch.arange(
        n_syms, dtype=torch.float32, device=dev)
    i0 = torch.floor(pos)
    frac = pos - i0
    i0 = torch.clamp(i0.to(torch.int64), _FD_SEMI, L - _FD_SEMI - 1)
    # polyphase fractional-delay sampling (windowed-sinc bank, lerped
    # between adjacent phases)
    bank = on(_fd_bank(), dev)
    ph = frac * _FD_NPFB
    p_lo = torch.floor(ph).to(torch.int64)
    w = (ph - p_lo.to(torch.float32))[..., None]
    taps = bank[p_lo] * (1 - w) + bank[p_lo + 1] * w     # [R, n_syms, 8]
    offs = torch.arange(-_FD_SEMI + 1, _FD_SEMI + 1, device=dev)
    wins = _row_gather(mf, row_of, i0[..., None] + offs)  # [R, n_syms, 8]
    raw = (wins * taps).sum(-1)

    # derotate CFO (phase referenced to n0)
    t = pos - n0f[:, None]
    syms = raw * _cis(-(cfo[:, None] * t))

    # complex gain from the preamble symbols
    pre = on(p.preamble, dev, torch.complex64)
    g = (syms[:, :PREAMBLE_SYMS] * torch.conj(pre)).sum(-1) / PREAMBLE_SYMS
    g = torch.where(g.abs() > 1e-9, g, torch.ones_like(g))
    syms = syms / g[:, None]

    # header, with carrier-phase tracking across its span, anchored by the
    # preamble symbols (known signs after derotation)
    hsyms = syms[:, PREAMBLE_SYMS:PREAMBLE_SYMS + hdr_syms]
    u_pre = syms[:, :PREAMBLE_SYMS] * torch.conj(pre)
    y_tr = torch.cat([u_pre, hsyms], dim=-1)
    sgn_known = torch.cat([torch.ones(PREAMBLE_SYMS, device=dev),
                           torch.zeros(hdr_syms, device=dev)])
    phi = track_phase_bpsk(y_tr, sgn_known, seg=32, n_iter=2)
    hsyms = hsyms * _cis(-phi[:, PREAMBLE_SYMS:])
    hdec = modem_mod.demodulate(HEADER_MOD, hsyms)
    if sync.soft:
        # exact-ML Golay from the channel LLRs
        (user, plen, mod, f0, f1, check,
         hvalid) = payload_codec.decode_header_points_soft(
            hsyms, sync.max_payload, len(sync.fecs),
            user_bytes=sync.header_user)
    else:
        hbits = modem_mod.symbols_to_bits(hdec, HEADER_BPS)
        hbytes = payload_codec.header_bits_to_bytes(
            hbits, user_bytes=sync.header_user)
        (user, plen, mod, f0, f1, check,
         hvalid) = payload_codec.decode_header(hbytes, sync.max_payload,
                                               len(sync.fecs),
                                               user_bytes=sync.header_user)
    hevm = modem_mod.evm(HEADER_MOD, hsyms, hdec)

    # payload section with a pilot-anchored phase line
    section = syms[:, PREAMBLE_SYMS + hdr_syms:]
    data_pos, pilot_pos, pil_ref, seg = _payload_layout(p.k, p.m, p.beta,
                                                        sync.max_slots)
    rot = section[:, on(pilot_pos, dev)] * torch.conj(on(pil_ref, dev))
    # pilots beyond this frame's payload may belong to the next burst:
    # zero them before the fit
    used_pts = payload_codec.payload_points_used(
        sync.fecs, sync.dec_max, sync.enc_max, plen, mod, f0, f1, check)
    n_slots_used = used_pts + -((-used_pts) // (PILOT_SPACING - 1))
    n_pil = rot.shape[-1]
    seg_valid = torch.where(hvalid, (n_slots_used + PILOT_SPACING - 1)
                            // PILOT_SPACING, torch.full_like(used_pts,
                                                              n_pil))
    w_pil = (torch.arange(n_pil, device=dev)[None, :] <
             seg_valid[:, None]).to(torch.float32)
    rot = rot * w_pil

    # global linear phase fit over the frame's pilots: slope from cascaded
    # diff-coherent lags (1 -> 8 -> 32), intercept from the slope-derotated
    # mean; no phase unwrap
    def _refine(sl, lag):
        if n_pil <= lag:
            return sl
        acc = (rot[:, lag:] * torch.conj(rot[:, :-lag]) *
               _cis(-(sl * lag))[:, None]).sum(-1)
        return sl + torch.angle(acc) / lag
    slope = torch.angle((rot[:, 1:] * torch.conj(rot[:, :-1])).sum(-1))
    slope = _refine(slope, 8)
    slope = _refine(slope, 32)                        # rad/segment
    s_idx = torch.arange(n_pil, dtype=torch.float32, device=dev)
    base = torch.angle((rot * _cis(-(slope[:, None] * s_idx))).sum(-1))
    corr = _cis(-(base[:, None] + slope[:, None] * on(seg, dev)))
    data = section[:, on(data_pos, dev)] * corr

    rssi = 20.0 * torch.log10(torch.clamp(g.abs(), min=1e-12))
    return (user, data, plen, mod, f0, f1, check, hvalid, rssi, hevm, cfo)


def _mf_and_detect(sync: FlexSync, ext: torch.Tensor):
    """Matched filter, preamble correlation and candidates for extended
    windows ``ext [R, L]``: ``(mf, metric, c1, c2, detected, locs)``.

    One forward FFT per window feeds the RRC matched filter and both
    preamble-half correlators (their host-precomputed responses compose by
    multiplication); the energy normalizer is JAX's float32 cumsum comb
    moving sum.  The metric is split-half noncoherent (``|c1|^2 +
    |c2|^2``), gated to 0 where the window energy is below ``1e-4 * 64 *
    mean |mf|^2``."""
    p = sync.params
    k = p.k
    L = ext.shape[-1]
    nt = len(p.taps)
    half = PREAMBLE_SYMS // 2
    span = (half - 1) * k + 1
    shift = half * k
    win = k * PREAMBLE_SYMS // 2
    region = sync.block_size + 2 * win + 1

    nfft = next_pow2(L + nt + span + shift)
    H, G1, G2 = (on(a, ext.device) for a in _fe_freq_np(p.k, p.m, p.beta,
                                                         nfft))
    F = torch.fft.fft(ext, nfft)
    Fm = F * H
    # mf[n] = full-conv(ext, taps)[n + nt - 1]
    mf = torch.fft.ifft(Fm)[..., nt - 1:nt - 1 + L]
    # c_half[n] = sum_i pre_half[i] mf[n + k i] at the combined offset
    off = nt - 1 + span - 1
    c1 = torch.fft.ifft(Fm * G1)[..., off:off + region]
    c2 = torch.fft.ifft(Fm * G2)[..., off + shift:off + shift + region]
    pw = mf.abs() ** 2
    e_half = comb_moving_sum(pw, half, k, region + shift)
    energy = e_half[..., :region] + e_half[..., shift:shift + region]
    metric = (c1.abs() ** 2 + c2.abs() ** 2) / \
        (torch.clamp(energy, min=1e-12) * (PREAMBLE_SYMS // 2))
    # silence gate
    floor = 1e-4 * PREAMBLE_SYMS * (pw.mean(-1, keepdim=True) + 1e-12)
    metric = torch.where(energy > floor, metric, torch.zeros_like(metric))
    detected, locs = _find_candidates(sync, metric)
    return mf, metric, c1, c2, detected, locs


def _gated_decode(sync: FlexSync, mf, metric, gate: bool, row_of, locs,
                  c1_at, c2_at, rows=None):
    """Batched candidate decode of flat candidates ``locs [R]`` (window
    ``row_of[r]`` of ``mf``/``metric``); the 12-tuple of per-candidate
    results, zeros when ``gate`` is False (nothing detected).  ``rows``
    (bool ``[R]``): the candidates whose conv/RS payload decodes (default
    all)."""
    R = locs.shape[0]
    dev = mf.device
    if not gate:
        z = lambda dt, *s: torch.zeros((R, *s), dtype=dt, device=dev)  # noqa: E731
        i32, f32 = torch.int32, torch.float32
        return (z(torch.uint8, sync.header_user),
                z(torch.uint8, sync.max_payload), z(i32), z(i32), z(i32),
                z(i32), z(i32), z(torch.bool), z(torch.bool), z(f32), z(f32),
                z(f32))
    (user, points, plen, mod, f0, f1, check, hvalid, rssi, hevm,
     cfo) = _decode_candidate(sync, mf, metric, row_of, locs, c1_at, c2_at)
    decode_fn = (payload_codec.decode_payload_batch_soft if sync.soft
                 else payload_codec.decode_payload_batch)
    payload, pvalid = decode_fn(
        sync.enc_max, sync.dec_max, sync.max_payload, points, mod, f0, f1,
        check, plen, hvalid, sync.fecs, rows=rows)
    # frame EVM = header + payload symbols (framesyncstats)
    used = payload_codec.payload_points_used(
        sync.fecs, sync.dec_max, sync.enc_max, plen, mod, f0, f1, check)
    evm = payload_codec.frame_evm_db(
        hevm, payload_codec.payload_evm_mse(points, mod, used), used,
        hdr_syms=payload_codec.header_syms(sync.header_user))
    evm = torch.where(hvalid, evm, hevm)
    return (user, payload, plen, mod, f0, f1, check, hvalid, pvalid, rssi,
            evm, cfo)


def _results(detected, locs, t_base, decoded, shape) -> FlexResults:
    (user, payload, plen, mod, f0, f1, check, hvalid, pvalid, rssi, evm,
     cfo) = decoded

    def rs(v):
        return v.reshape(shape + v.shape[1:])

    plen = rs(plen).to(torch.int32)
    return FlexResults(
        detected=detected,
        header_valid=detected & rs(hvalid),
        payload_valid=detected & rs(pvalid),
        header=rs(user), payload=rs(payload),
        payload_len=torch.where(detected, plen, torch.zeros_like(plen)),
        mod=rs(mod).to(torch.int32), fec0=rs(f0).to(torch.int32),
        fec1=rs(f1).to(torch.int32), check=rs(check).to(torch.int32),
        rssi=rs(rssi), evm=rs(evm), cfo=rs(cfo),
        t_start=t_base + locs.to(torch.int32))


def flex_sync_block(sync: FlexSync, state: FlexSyncState,
                    block: torch.Tensor):
    """Process ``block_size`` samples (complex, or ``[2, bs]`` IQ planes)
    -> ``(state', FlexResults [max_frames])``: a batched dispatch of one
    block."""
    new_state, res = flex_sync_blocks_batched(sync, state,
                                              iq_from_any(block)[None])
    return new_state, FlexResults(*(v[0] for v in res))


def make_flex_sync_step(sync: FlexSync):
    """``step(state, block) -> (state', FlexResults)`` closure over one
    config (JAX jits this closure; the port runs it eagerly)."""
    def step(state: FlexSyncState, block: torch.Tensor):
        return flex_sync_block(sync, state, block)
    return step


def flex_sync_blocks_batched(sync: FlexSync, state: FlexSyncState,
                             blocks: torch.Tensor):
    """Multi-block batched dispatch: ``blocks [n_blocks, block_size]`` (or
    IQ planes ``[2, n_blocks, block_size]``) -> ``(state', FlexResults
    [n_blocks, max_frames])``.  The front end runs over every block's
    extended window at once (each the window the sequential steps see) and
    every candidate decodes against its own window, so the detected rows
    equal a sequence of :func:`flex_sync_block` steps."""
    blocks = iq_from_any(blocks)
    n_blocks, bs = blocks.shape
    if bs != sync.block_size:
        raise ValueError(f"blocks of {bs} samples, sync expects "
                         f"{sync.block_size}")
    K = sync.max_frames
    dev = blocks.device
    full = torch.cat([state.tail, blocks.reshape(-1)])
    exts = full.unfold(0, sync.overlap + bs, bs)     # [n_blocks, overlap+bs]
    mf, metric, c1, c2, detected, locs = _mf_and_detect(sync, exts)
    row_of = torch.arange(n_blocks, device=dev).repeat_interleave(K)
    locs_f = locs.reshape(-1)
    decoded = _gated_decode(sync, mf, metric, bool(detected.any()), row_of,
                            locs_f, _row_gather(c1, row_of, locs_f),
                            _row_gather(c2, row_of, locs_f),
                            detected.reshape(-1))
    t_base = state.base + (torch.arange(n_blocks, dtype=torch.int32,
                                        device=dev) * bs)[:, None]
    res = _results(detected, locs, t_base, decoded, (n_blocks, K))
    new_state = FlexSyncState(tail=full[full.shape[0] - sync.overlap:],
                              base=state.base + n_blocks * bs)
    return new_state, res
