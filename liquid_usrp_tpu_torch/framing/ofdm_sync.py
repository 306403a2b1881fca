"""OFDM flexframe synchronizer (RX) — batched block dataflow.

Port of ``liquid_usrp_tpu/framing/ofdm_sync.py``.  The stream is processed
in fixed-size blocks with an overlap of one maximum frame length:

1. **Detect** — a metric over every offset of each extended window
   (``tail ++ block``), non-max suppression and a top-k pick the candidate
   frame starts.  ``OfdmSync.use_pallas`` selects the detector exactly as
   in JAX: 0 = segmented S0 cross-correlation through ``torch.fft``;
   1 = the same metric by kernel B1; 2 = the fused Schmidl-Cox candidate
   kernel B2 (M >= 32).  The legacy Schmidl-Cox detector
   (``xcorr_detect=False``, and level 2 below M = 32) takes its metric from
   kernel B3 at levels 1 and 2.  The kernels live in ``ops/kernels.py``.
2. **Refine & decode** — batched over all candidates: coarse and fine CFO,
   S1 fine timing, channel estimate, pilot-tracked equalization, header
   decode, decision-directed channel refinement, payload demap and FEC.

Where JAX ``vmap``s over candidates and windows, every function here takes
a leading batch axis.  Where JAX gates the decode with ``lax.cond``, the
port uses a host ``if`` on ``detected.any()`` (one device sync per step).
Results are fixed-shape with ``detected``/valid masks; the unmasked fields
of undetected rows are unspecified, as in JAX.

``use_pallas="auto"`` resolves to 1 here (kernel B1 on the card), where the
JAX package resolves it to 0 from a TPU measurement.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import kernels
from ..ops import modem as modem_mod
from ..ops.corr import comb_rev_freq_np, find_candidates, next_pow2
from ..ops.corr import topk_peaks  # noqa: F401  (JAX module surface)
from ..utils.consts import on
from ..utils.device import default_device
from ..utils.profiling import count, span
from . import payload as payload_codec
from .ofdm import NUM_S0, OfdmParams, _pilot_values, header_symbol_count
from .payload import (EXPANSION as _EXPANSION, HEADER_BPS as _HEADER_BPS,
                      HEADER_MOD as _HEADER_MOD, HEADER_SYMS, PAYLOAD_FECS,
                      PAYLOAD_FECS_FULL, PAYLOAD_MODS)

__all__ = ["OfdmSync", "OfdmSyncState", "FrameResults", "SyncTables",
           "make_sync", "sync_init", "sync_tables", "sync_block",
           "make_sync_step", "sync_blocks_batched", "sync_channels_batched",
           "extended_windows", "debug_capture", "PAYLOAD_FECS",
           "PAYLOAD_MODS"]

# payload symbols feeding the decision-directed channel re-estimation
_DD_SYMS = 64
_XC_SEG = 24                    # xcorr coherence-segment length (samples)


class OfdmSync(NamedTuple):
    params: OfdmParams
    block_size: int            # samples consumed per step
    max_payload: int           # static payload decode budget (bytes)
    max_frames: int            # candidates per block
    threshold: float           # detection metric threshold in (0, 1)
    overlap: int               # carried tail length (>= max frame length)
    max_psym: int              # payload OFDM symbols budget
    dec_max: int               # payload + max CRC bytes
    enc_max: int               # encoded payload buffer bytes
    fecs: tuple = PAYLOAD_FECS # runtime-decodable payload FEC set
    soft: bool = False         # soft-decision LLRs into Golay and conv FEC
    use_pallas: int = 0        # detect kernel level: 0, 1 or 2 (B1-B3)
    xcorr_detect: bool = True  # segmented S0 xcorr metric (vs Schmidl-Cox)
    iter_header: bool = True   # second header decode on the DD channel


class OfdmSyncState(NamedTuple):
    tail: torch.Tensor         # [..., overlap] complex64
    base: torch.Tensor         # int32 stream index of tail[0] (wraps at 2^31)


class FrameResults(NamedTuple):
    """Fixed-shape per-block results; trailing candidate dim = max_frames."""
    detected: torch.Tensor      # bool
    header_valid: torch.Tensor  # bool
    payload_valid: torch.Tensor # bool
    header: torch.Tensor        # [..., 8] uint8
    payload: torch.Tensor       # [..., max_payload] uint8
    payload_len: torch.Tensor   # int32
    mod: torch.Tensor           # int32
    fec0: torch.Tensor          # int32
    fec1: torch.Tensor          # int32
    check: torch.Tensor         # int32
    rssi: torch.Tensor          # float32 dB
    evm: torch.Tensor           # float32 dB
    cfo: torch.Tensor           # float32 rad/sample
    t_start: torch.Tensor       # int32 stream sample index of S0 start


def make_sync(params: OfdmParams, block_size: int = 16384,
              max_payload: int = 2048, max_frames: int = 8,
              threshold: float = 0.5, enable_conv: bool = False,
              soft: bool = False, use_pallas="auto",
              xcorr_detect: bool = True, iter_header: bool = True,
              expansion: int = _EXPANSION) -> OfdmSync:
    if expansion < 1:
        raise ValueError(f"expansion must be >= 1 (got {expansion})")
    M, cp = params.M, params.cp_len
    n_data = len(params.data_idx)
    dec_max = max_payload + 4
    enc_max = expansion * dec_max
    # +1 point: DPSK payloads lead with a phase-reference point
    max_psym = -(-(enc_max * 8 + 1) // n_data)
    n_hsym = header_symbol_count(params)
    max_frame = (NUM_S0 + 1) * M + (n_hsym + max_psym) * (M + cp)
    overlap = max_frame + 4 * M
    if use_pallas == "auto":
        use_pallas = 1      # kernel B1; JAX resolves "auto" to 0 on TPU
    return OfdmSync(params=params, block_size=block_size,
                    max_payload=max_payload, max_frames=max_frames,
                    threshold=threshold, overlap=overlap, max_psym=max_psym,
                    dec_max=dec_max, enc_max=enc_max,
                    fecs=PAYLOAD_FECS_FULL if enable_conv else PAYLOAD_FECS,
                    soft=bool(soft), use_pallas=int(use_pallas),
                    xcorr_detect=bool(xcorr_detect),
                    iter_header=bool(iter_header))


def sync_init(sync: OfdmSync, device=None) -> OfdmSyncState:
    dev = default_device(device)
    return OfdmSyncState(
        tail=torch.zeros(sync.overlap, dtype=torch.complex64, device=dev),
        base=torch.tensor(-sync.overlap, dtype=torch.int32, device=dev))


def _xc_span(n_tmpl: int) -> int:
    """Coherence-segment length: the largest divisor of the template
    length <= _XC_SEG."""
    for span in range(min(_XC_SEG, n_tmpl), 0, -1):
        if n_tmpl % span == 0:
            return span
    return n_tmpl


def _freq_offsets(idx: np.ndarray, M: int) -> np.ndarray:
    """Signed (centered) frequency positions of FFT-order carriers."""
    return np.where(idx > M // 2, idx - M, idx).astype(np.float32)


class SyncTables(torch.nn.Module):
    """Device tables of one synchronizer configuration, as buffers: the
    S0/S1 preamble spectra and time template, the pilot tables and carrier
    maps, and the FFT-domain xcorr template responses of detect level 0.

    Kernel B1 bakes the xcorr template into ``__constant__`` memory from
    the host copy ``xc_tmpl`` (a NumPy array, like the JAX kernel's
    compile-time coefficients)."""

    def __init__(self, sync: OfdmSync):
        super().__init__()
        p = sync.params
        M = p.M
        self.xc_tmpl = np.tile(p.s0_time, NUM_S0).astype(np.complex64)
        span = _xc_span(len(self.xc_tmpl))
        n_seg = len(self.xc_tmpl) // span
        nfft = next_pow2(sync.overlap + sync.block_size + NUM_S0 * M)
        Gs = np.stack([comb_rev_freq_np(
            np.conj(self.xc_tmpl[s * span:(s + 1) * span]), 1, nfft)
            for s in range(n_seg)])
        ea = np.array([np.sum(np.abs(self.xc_tmpl[s * span:(s + 1) * span])
                              ** 2) for s in range(n_seg)], np.float32)
        active = sorted(set(p.data_idx.tolist()) | set(p.pilot_idx.tolist()))
        act_sorted = np.array(active)[np.argsort(
            [k - M if k > M // 2 else k for k in active])]
        bufs = {
            "xc_G": torch.as_tensor(Gs), "xc_ea": torch.as_tensor(ea),
            "s1_conj": torch.as_tensor(np.conj(p.s1_time)),
            "s1_freq": torch.as_tensor(p.s1_freq),
            "s0_freq": torch.as_tensor(p.s0_freq),
            "pilot_idx": torch.as_tensor(p.pilot_idx.astype(np.int64)),
            "data_idx": torch.as_tensor(p.data_idx.astype(np.int64)),
            "act_sorted": torch.as_tensor(act_sorted.astype(np.int64)),
            "f_pilot": torch.as_tensor(_freq_offsets(p.pilot_idx, M)),
            "f_data": torch.as_tensor(_freq_offsets(p.data_idx, M)),
        }
        for name, t in bufs.items():
            self.register_buffer(name, t, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.s1_freq.device


_TABLES: dict = {}


def sync_tables(sync: OfdmSync, device) -> SyncTables:
    """The :class:`SyncTables` of ``sync`` on ``device`` (built once)."""
    key = (id(sync.params), sync.block_size, sync.overlap,
           str(torch.device(device)))
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not sync.params:
        hit = _TABLES[key] = (sync.params, SyncTables(sync).to(device))
    return hit[1]


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def _detect_metric(sync: OfdmSync, ext: torch.Tensor):
    """S0 periodicity (Schmidl-Cox) metric ``(metric, c)`` for every offset
    of each window ``ext [..., L]``: kernel B3 when ``use_pallas > 0``."""
    M = sync.params.M
    d = M // 4
    if sync.use_pallas:
        return kernels.detect_metric_onepass(ext, d, NUM_S0 * M - d)
    return kernels.autocorr_metric(ext, d, NUM_S0 * M - d)


def _detect_metric_xcorr(sync: OfdmSync, ext: torch.Tensor,
                         tables: SyncTables) -> torch.Tensor:
    """Segmented-coherent S0 cross-correlation metric ``[R, n_metric]``
    through ``torch.fft``: per coherence segment, the correlation with the
    reversed template segment in the frequency domain, normalized per
    segment and gated by the segment energy, then averaged over the fixed
    segment count."""
    M = sync.params.M
    n_metric = sync.block_size + 2 * M + 1
    n_tmpl = NUM_S0 * M
    span = _xc_span(n_tmpl)
    n_seg = n_tmpl // span
    nfft = tables.xc_G.shape[-1]
    if ext.shape[-1] + n_tmpl > nfft:
        raise ValueError("window longer than the sync's FFT plan")
    F = torch.fft.fft(ext, nfft)                              # [R, nfft]
    U = torch.fft.ifft(F[:, None, :] * tables.xc_G[None], dim=-1)
    pw = torch.abs(ext) ** 2
    e24 = kernels._moving_sum(torch.nn.functional.pad(pw, (0, n_tmpl)),
                              span)
    seg_floor = (1e-4 * span * (pw.mean(-1) + 1e-12))[:, None]
    acc = torch.zeros((ext.shape[0], n_metric), dtype=torch.float32,
                      device=ext.device)
    for s in range(n_seg):
        off = s * span + span - 1
        u = U[:, s, off:off + n_metric]
        Es = e24[:, s * span:s * span + n_metric]
        r = (u.real ** 2 + u.imag ** 2) / \
            torch.clamp(Es * tables.xc_ea[s], min=1e-12)
        acc = acc + torch.where(Es > seg_floor, r, torch.zeros_like(r))
    return acc / n_seg


def _find_candidates(sync: OfdmSync, metric: torch.Tensor):
    """``(detected, locs)``: non-max-suppressed top-k offsets in the detect
    region ``[win, block_size + win)``, ``win = M``."""
    vals, locs = find_candidates(metric, sync.params.M, sync.block_size,
                                 sync.threshold, sync.max_frames)
    return vals > 0, locs


def _c_at(sync: OfdmSync, ext: torch.Tensor, locs: torch.Tensor):
    """Lag-M/4 windowed correlation (coarse-CFO phase reference) at the
    candidate offsets only: ``c[n] = sum_i ext[n+i] conj(ext[n+i+d])``."""
    M = sync.params.M
    d = M // 4
    L = NUM_S0 * M - d
    R, K = locs.shape
    idx = locs.to(torch.int64)[..., None] + \
        torch.arange(L, device=ext.device)
    idx = torch.clamp(idx, 0, ext.shape[-1] - 1 - d).reshape(R, K * L)
    a = torch.gather(ext, -1, idx)
    b = torch.gather(ext, -1, idx + d)
    return (a * torch.conj(b)).reshape(R, K, L).sum(-1)


def _detect_candidates(sync: OfdmSync, ext: torch.Tensor,
                       tables: SyncTables):
    """``(detected, locs, c_at)`` ``[R, max_frames]`` for windows
    ``ext [R, L]``."""
    M = sync.params.M
    d = M // 4
    L = NUM_S0 * M - d
    if sync.use_pallas == 2 and M >= 32:
        # M < 32 falls through: the fused kernel's 64-sample segments are
        # only equivalent to topk_peaks when min(64, 2M+1) == 64
        vals, locs, c_at = kernels.detect_candidates_onepass(
            ext, d, L, M, sync.block_size, sync.threshold, sync.max_frames)
        return vals > 0, locs, c_at
    if sync.xcorr_detect and sync.use_pallas <= 1:
        if sync.use_pallas == 1:
            metric = kernels.detect_metric_xcorr_onepass(
                ext, tables.xc_tmpl, _xc_span(len(tables.xc_tmpl)),
                sync.block_size + 2 * M + 1)
        else:
            metric = _detect_metric_xcorr(sync, ext, tables)
        detected, locs = _find_candidates(sync, metric)
        return detected, locs, _c_at(sync, ext, locs)
    metric, c = _detect_metric(sync, ext)
    detected, locs = _find_candidates(sync, metric)
    idx = torch.clamp(locs.to(torch.int64), 0, c.shape[-1] - 1)
    return detected, locs, torch.gather(c, -1, idx)


# ---------------------------------------------------------------------------
# per-candidate decode (batched over a leading candidate axis)
# ---------------------------------------------------------------------------

def _cis(x: torch.Tensor) -> torch.Tensor:
    """``exp(1j * x)`` for real ``x`` (complex64)."""
    return torch.polar(torch.ones_like(x), x)


def _slice_rows(x: torch.Tensor, start: torch.Tensor, length: int
                ) -> torch.Tensor:
    """``x[r, start[r] : start[r] + length]`` per row, with the start
    clamped into ``[0, len - length]`` (``lax.dynamic_slice`` semantics)."""
    start = torch.clamp(start.to(torch.int64), 0, x.shape[-1] - length)
    idx = start[:, None] + torch.arange(length, device=x.device)
    return torch.gather(x, -1, idx)


def _window_gather(source: torch.Tensor, row_of: torch.Tensor,
                   start: torch.Tensor, length: int) -> torch.Tensor:
    """Window ``source[row_of[r], start[r] : start[r] + length]`` per
    candidate, start clamped as ``lax.dynamic_slice`` clamps it (a window
    past the end shifts left)."""
    n = source.shape[-1]
    start = torch.clamp(start.to(torch.int64), 0, n - length)
    idx = (row_of.to(torch.int64) * n + start)[:, None] + \
        torch.arange(length, device=source.device)
    return source.reshape(-1)[idx]


def _equalized_symbols(sync: OfdmSync, tables: SyncTables, w: torch.Tensor,
                       body_start: torch.Tensor, H: torch.Tensor,
                       n_sym: int, first_abs_sym: int, n_valid_sym=None):
    """Demodulate ``n_sym`` OFDM symbols of each derotated window ``w [R,
    W]`` from ``body_start [R]``: equalized data-carrier values ``[R,
    n_sym, n_data]`` after pilot common-phase (weighted line fit over the
    unwrapped per-symbol phases) and global timing-slope correction.
    ``n_valid_sym [R]`` gates symbols beyond each frame out of the fits."""
    p = sync.params
    M, cp = p.M, p.cp_len
    R = w.shape[0]
    span = n_sym * (M + cp)
    wpad = torch.nn.functional.pad(w, (0, span + cp))
    seg = _slice_rows(wpad, body_start + cp, span)
    time_syms = seg.reshape(R, n_sym, M + cp)[..., :M]
    Y = torch.fft.fft(time_syms, dim=-1) / \
        torch.sqrt(torch.tensor(M, dtype=torch.float32))
    Hsafe = torch.where(torch.abs(H) > 1e-6, H, torch.ones_like(H))
    Yeq = Y / Hsafe[:, None, :]
    sym_abs = first_abs_sym + torch.arange(n_sym, device=w.device)
    pref = _pilot_values(p, sym_abs).to(torch.complex64)  # [n_sym, n_pil]
    rot = Yeq[..., tables.pilot_idx] * torch.conj(pref)   # [R, n_sym, n_pil]
    rsum = rot.sum(-1)
    cpe_raw = torch.angle(rsum)                           # [R, n_sym]
    dphi = torch.remainder(torch.diff(cpe_raw, dim=-1) + np.pi,
                           2 * np.pi) - np.pi
    cpe_u = torch.cat([cpe_raw[:, :1],
                       cpe_raw[:, :1] + torch.cumsum(dphi, dim=-1)], dim=-1)
    wgt_s = torch.abs(rsum)
    t_i = torch.arange(n_sym, dtype=torch.float32, device=w.device)
    if n_valid_sym is not None:
        wgt_s = torch.where(t_i < n_valid_sym[:, None], wgt_s,
                            torch.zeros_like(wgt_s))
    wgt_s = wgt_s + 1e-9
    wsum = wgt_s.sum(-1, keepdim=True)
    tbar = (wgt_s * t_i).sum(-1, keepdim=True) / wsum
    cbar = (wgt_s * cpe_u).sum(-1, keepdim=True) / wsum
    bnum = (wgt_s * (t_i - tbar) * (cpe_u - cbar)).sum(-1, keepdim=True)
    bden = torch.clamp((wgt_s * (t_i - tbar) ** 2).sum(-1, keepdim=True),
                       min=1e-6)
    cpe = cbar + (bnum / bden) * (t_i - tbar)             # [R, n_sym]
    f = tables.f_pilot
    th = torch.angle(rot * _cis(-cpe)[..., None])
    wpool = torch.abs(rot) * (wgt_s[..., None] > 1e-8)
    denom = torch.clamp((wpool * f * f).sum((-2, -1)), min=1e-6)
    slope = (wpool * th * f).sum((-2, -1)) / denom        # [R]
    corr = _cis(-(cpe[..., None] + slope[:, None, None] * tables.f_data))
    return Yeq[..., tables.data_idx] * corr


def _demod_header(sync: OfdmSync, hflat: torch.Tensor):
    """Header points ``[R, HEADER_SYMS]`` -> (hard symbols, header fields):
    hard Golay from the symbols, or with ``sync.soft`` exact-ML Golay from
    the channel LLRs.  The hard symbols drive the header EVM and the
    decision-directed channel refinement either way."""
    hsym = modem_mod.demodulate(_HEADER_MOD, hflat)
    if sync.soft:
        return hsym, payload_codec.decode_header_points_soft(
            hflat, sync.max_payload, len(sync.fecs))
    hbits = modem_mod.symbols_to_bits(hsym, _HEADER_BPS)
    fields = payload_codec.decode_header(
        payload_codec.header_bits_to_bytes(hbits), sync.max_payload,
        len(sync.fecs))
    return hsym, fields


def _decode_window(sync: OfdmSync, tables: SyncTables, wraw: torch.Tensor,
                   c_at: torch.Tensor, debug: bool = False):
    """Refine + decode windows ``wraw [R, W]`` (each from a candidate
    offset) with their lag correlations ``c_at [R]``.  ``debug=True``
    appends a dict of synchronizer internals (``H``, ``t1``, ``hsyms_eq``,
    ``used_pts``, each with the leading ``[R]``) for :func:`debug_capture`."""
    p = sync.params
    M, cp = p.M, p.cp_len
    n_hsym = header_symbol_count(p)
    R, W = wraw.shape
    dev = wraw.device

    # coarse CFO from the lag-M/4 correlation, then the fine stage on the
    # period-M repetition of the two S0 symbols
    cfo = -torch.angle(c_at) / (M // 4)
    t = torch.arange(W, dtype=torch.float32, device=dev)
    c_fine = (wraw[:, :M] * torch.conj(wraw[:, M:2 * M])).sum(-1) * \
        _cis(cfo * M)
    cfo = cfo - torch.angle(c_fine) / M
    w = wraw * _cis(-cfo[:, None] * t)

    # fine timing: S1 matched filter over [0, (NUM_S0+2)*M)
    search = (NUM_S0 + 2) * M
    wins = w[:, :search + M].unfold(-1, M, 1)[:, :search]   # [R, search, M]
    corr = wins @ tables.s1_conj
    energy = torch.sqrt(torch.clamp((torch.abs(wins) ** 2).sum(-1),
                                    min=1e-12))
    t1 = torch.argmax(torch.abs(corr) / energy, dim=-1)    # [R] int64

    # channel estimate from S1, S0-augmented where t1 >= 2M
    sqrtM = torch.sqrt(torch.tensor(M, dtype=torch.float32))
    R1 = torch.fft.fft(_slice_rows(w, t1, M), dim=-1) / sqrtM
    s1f = tables.s1_freq
    H = torch.where(torch.abs(s1f) > 1e-6,
                    R1 * torch.conj(s1f) /
                    torch.clamp(torch.abs(s1f) ** 2, min=1e-12),
                    torch.ones_like(R1))
    r0 = _slice_rows(w, torch.clamp(t1 - 2 * M, min=0), 2 * M)
    R0 = (torch.fft.fft(r0[:, :M], dim=-1) +
          torch.fft.fft(r0[:, M:], dim=-1)) / (2.0 * sqrtM)
    s0f = tables.s0_freq
    act0 = (torch.abs(s0f) > 1e-6)[None, :] & (t1 >= 2 * M)[:, None]
    H0 = R0 * torch.conj(s0f) / torch.clamp(torch.abs(s0f) ** 2, min=1e-12)
    H = torch.where(act0, (H + 2.0 * H0) / 3.0, H)
    # [1 2 1]/4 smoothing across physically adjacent active carriers
    Ha = H[:, tables.act_sorted]
    Hpad = torch.cat([Ha[:, :1], Ha, Ha[:, -1:]], dim=-1)
    H = H.clone()
    H[:, tables.act_sorted] = 0.25 * Hpad[:, :-2] + 0.5 * Hpad[:, 1:-1] + \
        0.25 * Hpad[:, 2:]

    body = t1 + M
    hdata = _equalized_symbols(sync, tables, w, body, H, n_hsym, 0)
    hflat = hdata.reshape(R, -1)[:, :HEADER_SYMS]
    hsym, (user, plen, mod, f0, f1, check, hvalid) = \
        _demod_header(sync, hflat)
    hevm = modem_mod.evm(_HEADER_MOD, hflat, hsym)

    # decision-directed channel refinement from the header decisions
    n_data = len(p.data_idx)
    dec_pts = modem_mod.modulate(_HEADER_MOD, hsym)
    pad = n_hsym * n_data - HEADER_SYMS
    dec_grid = torch.nn.functional.pad(dec_pts, (0, pad)).reshape(
        R, n_hsym, n_data)
    used = torch.nn.functional.pad(
        torch.ones(HEADER_SYMS, dtype=torch.float32, device=dev),
        (0, pad)).reshape(n_hsym, n_data)
    nobs = used.sum(0)
    r = (hdata * torch.conj(dec_grid) * used).sum(-2) / \
        torch.clamp(nobs, min=1.0)
    r = (nobs * r + 1.0) / (nobs + 1.0)
    r = torch.where(torch.abs(r) > 0.2, r, torch.ones_like(r))

    if sync.iter_header:
        # second header decode on the DD-refined channel; fields merge
        # only where pass 1 failed
        hflat2 = (hdata / r[:, None, :]).reshape(R, -1)[:, :HEADER_SYMS]
        _, (user2, plen2, mod2, f02, f12, check2, hvalid2) = \
            _demod_header(sync, hflat2)
        take = (~hvalid) & hvalid2
        user = torch.where(take[:, None], user2, user)
        plen = torch.where(take, plen2, plen)
        mod = torch.where(take, mod2, mod)
        f0 = torch.where(take, f02, f0)
        f1 = torch.where(take, f12, f1)
        check = torch.where(take, check2, check)
        hvalid = hvalid | hvalid2

    used_pts = payload_codec.payload_points_used(
        sync.fecs, sync.dec_max, sync.enc_max, plen, mod, f0, f1, check)
    n_valid = torch.clamp(-((-used_pts) // n_data), 1, sync.max_psym)
    pdata = _equalized_symbols(
        sync, tables, w, body + n_hsym * (M + cp), H, sync.max_psym, n_hsym,
        n_valid_sym=torch.where(hvalid, n_valid,
                                torch.full_like(n_valid, sync.max_psym)))
    pdata = pdata / r[:, None, :]

    if sync.max_psym > 0:
        # second decision-directed pass over the first payload symbols,
        # with the header-advertised constellation (padded entries never
        # win), weighted by decision energy and masked to this frame
        dd = min(_DD_SYMS, sync.max_psym)
        tab = on(payload_codec._stacked_tables(), dev)[mod.to(torch.int64)]
        sub = pdata[:, :dd]                                 # [R, dd, n_data]
        dec, _ = payload_codec._nearest_point(sub.reshape(R, -1), tab)
        dec = dec.reshape(sub.shape)
        pt_i = torch.arange(dd, device=dev)[:, None] * n_data + \
            torch.arange(n_data, device=dev)[None, :]
        dec_e = torch.abs(dec) ** 2
        wgt = ((pt_i < used_pts[:, None, None]) &
               hvalid[:, None, None]).to(torch.float32) * dec_e
        num = (sub * torch.conj(dec) * wgt).sum(-2)
        den = (dec_e * wgt).sum(-2)
        r2 = (num + 1.0) / (den + 1.0)
        r2 = torch.where(torch.abs(r2) > 0.2, r2, torch.ones_like(r2))
        pdata = pdata / r2[:, None, :]

    rssi = 10.0 * torch.log10(torch.clamp(
        (torch.abs(wraw[:, :NUM_S0 * M]) ** 2).mean(-1), min=1e-12))
    out = (user, pdata.reshape(R, -1), plen, mod, f0, f1, check, hvalid,
           rssi, hevm, cfo)
    if debug:
        return out + ({"H": H, "t1": t1, "hsyms_eq": hflat,
                       "used_pts": used_pts},)
    return out


# ---------------------------------------------------------------------------
# block steps
# ---------------------------------------------------------------------------

def _gated_decode(sync: OfdmSync, tables: SyncTables, source: torch.Tensor,
                  gate: bool, locs: torch.Tensor, c_at: torch.Tensor,
                  row_of: torch.Tensor, rows: torch.Tensor = None):
    """Batched candidate decode against windows ``source [rows, L]``:
    candidate ``r`` reads the window at ``locs[r]`` of row ``row_of[r]``.
    Returns the 12-tuple of per-candidate results, zeros when ``gate`` is
    False (nothing detected: the decode is skipped).  ``rows`` (bool
    ``[R]``): the candidates whose conv/RS payload decodes (default
    all).  One ``rx.decode`` span, the payload codec's ``rx.codec``
    inside it; counts ``rows_decoded``."""
    with span("rx.decode"):
        R = locs.shape[0]
        dev = source.device
        if not gate:
            def z(dt, *s):
                return torch.zeros((R, *s), dtype=dt, device=dev)
            i32, f32 = torch.int32, torch.float32
            return (z(torch.uint8, 8), z(torch.uint8, sync.max_payload),
                    z(i32), z(i32), z(i32), z(i32), z(i32), z(torch.bool),
                    z(torch.bool), z(f32), z(f32), z(f32))
        count("rows_decoded", R)
        win = _window_gather(source, row_of, locs, sync.overlap)
        (user, points, plen, mod, f0, f1, check, hvalid, rssi, hevm,
         cfo) = _decode_window(sync, tables, win, c_at)
        decode_fn = (payload_codec.decode_payload_batch_soft if sync.soft
                     else payload_codec.decode_payload_batch)
        with span("rx.codec"):
            payload, pvalid = decode_fn(
                sync.enc_max, sync.dec_max, sync.max_payload, points, mod, f0,
                f1, check, plen, hvalid, sync.fecs, rows=rows)
        used = payload_codec.payload_points_used(
            sync.fecs, sync.dec_max, sync.enc_max, plen, mod, f0, f1, check)
        evm = payload_codec.frame_evm_db(
            hevm, payload_codec.payload_evm_mse(points, mod, used), used)
        evm = torch.where(hvalid, evm, hevm)
        return (user, payload, plen, mod, f0, f1, check, hvalid, pvalid, rssi,
                evm, cfo)


def _detected_rows(detected: torch.Tensor) -> int:
    """The detected candidates, counted on the host from one copy of the
    mask: the decode gate's one wait (counts ``rows_detected``)."""
    n = int(np.count_nonzero(detected.cpu().numpy()))
    count("rows_detected", n)
    return n


def _results(detected, locs, base_t, decoded, shape) -> FrameResults:
    (user, payload, plen, mod, f0, f1, check, hvalid, pvalid, rssi, evm,
     cfo) = decoded

    def rs(v):
        return v.reshape(shape + v.shape[1:])

    detected = detected.reshape(shape)
    return FrameResults(
        detected=detected,
        header_valid=detected & rs(hvalid),
        payload_valid=detected & rs(pvalid),
        header=rs(user), payload=rs(payload),
        payload_len=torch.where(detected, rs(plen), torch.zeros_like(
            rs(plen))),
        mod=rs(mod), fec0=rs(f0), fec1=rs(f1), check=rs(check),
        rssi=rs(rssi), evm=rs(evm), cfo=rs(cfo),
        t_start=base_t + locs.reshape(shape).to(torch.int32))


def sync_block(sync: OfdmSync, state: OfdmSyncState, block: torch.Tensor,
               tables: SyncTables | None = None):
    """Process one block of ``block_size`` samples: ``(state',
    FrameResults [max_frames])``."""
    from ..ops.iqfmt import iq_from_any
    block = iq_from_any(block)
    if block.shape[-1] != sync.block_size:
        raise ValueError(f"block of {block.shape[-1]} samples, sync expects "
                         f"{sync.block_size}")
    tables = tables if tables is not None else sync_tables(sync,
                                                           block.device)
    with span("rx.detect"):
        ext = torch.cat([state.tail, block])[None]
        detected, locs, c_at = _detect_candidates(sync, ext, tables)
        gate = _detected_rows(detected) > 0
    K = sync.max_frames
    row_of = torch.zeros(K, dtype=torch.int64, device=block.device)
    decoded = _gated_decode(sync, tables, ext, gate, locs.reshape(-1),
                            c_at.reshape(-1), row_of, detected.reshape(-1))
    with span("rx.results"):
        res = _results(detected, locs, state.base, decoded, (K,))
    new_state = OfdmSyncState(tail=ext[0, ext.shape[-1] - sync.overlap:],
                              base=state.base + sync.block_size)
    return new_state, res


def make_sync_step(sync: OfdmSync):
    """``step(state, block) -> (state', FrameResults)`` closure over one
    config (JAX jits this closure; the port runs it eagerly, with the
    device tables built once per device)."""
    def step(state: OfdmSyncState, block: torch.Tensor):
        return sync_block(sync, state, block)
    return step


def sync_blocks_batched(sync: OfdmSync, state: OfdmSyncState,
                        blocks: torch.Tensor):
    """Multi-block batched dispatch: ``blocks [n_blocks, block_size]`` (or
    IQ planes ``[2, n_blocks, block_size]``) -> ``(state', FrameResults
    [n_blocks, max_frames])``: the one-channel case of
    :func:`sync_channels_batched`, where each candidate decodes against its
    own block's extended window, as the sequential steps see it."""
    from ..ops.iqfmt import iq_from_any
    states = OfdmSyncState(tail=state.tail[None], base=state.base[None])
    states, res = sync_channels_batched(sync, states,
                                        iq_from_any(blocks)[None])
    return (OfdmSyncState(tail=states.tail[0], base=states.base[0]),
            FrameResults(*(v[0] for v in res)))


def extended_windows(sync: OfdmSync, tail: torch.Tensor,
                     chans: torch.Tensor):
    """``(full, exts)``: each channel's stream ``tail ++ blocks`` ``[N,
    overlap + n_blocks*bs]`` and every block's extended window ``[N *
    n_blocks, overlap + bs]`` (the rows the detect front end runs on)."""
    N, n_blocks, bs = chans.shape
    full = torch.cat([tail, chans.reshape(N, -1)], dim=-1)
    exts = full.unfold(-1, sync.overlap + bs, bs).reshape(
        N * n_blocks, sync.overlap + bs)
    return full, exts


def sync_channels_batched(sync: OfdmSync, states: OfdmSyncState,
                          chans: torch.Tensor,
                          tables: SyncTables | None = None):
    """Channel-and-block batched dispatch for N independent streams.

    ``states``: stacked per-channel state (leading [N]); ``chans [N,
    n_blocks, block_size]`` -> ``(states', FrameResults [N, n_blocks,
    max_frames])``.  The detect front-end runs over all ``N * n_blocks``
    extended windows at once and every candidate decodes in one batch
    behind one global gate."""
    from ..ops.iqfmt import iq_from_any
    chans = iq_from_any(chans)
    N, n_blocks, bs = chans.shape
    if bs != sync.block_size:
        raise ValueError(f"blocks of {bs} samples, sync expects "
                         f"{sync.block_size}")
    tables = tables if tables is not None else sync_tables(sync,
                                                           chans.device)
    K = sync.max_frames
    with span("rx.detect"):
        full, exts = extended_windows(sync, states.tail, chans)
        detected, locs, c_at = _detect_candidates(sync, exts, tables)
        gate = _detected_rows(detected) > 0
    row_of = torch.arange(N * n_blocks, device=chans.device
                          ).repeat_interleave(K)
    decoded = _gated_decode(sync, tables, exts, gate, locs.reshape(-1),
                            c_at.reshape(-1), row_of, detected.reshape(-1))
    with span("rx.results"):
        base_t = states.base[:, None, None] + \
            (torch.arange(n_blocks, device=chans.device, dtype=torch.int32)
             * bs)[None, :, None]
        res = _results(detected, locs, base_t, decoded, (N, n_blocks, K))
    new_states = OfdmSyncState(
        tail=full[:, full.shape[-1] - sync.overlap:],
        base=states.base + n_blocks * bs)
    return new_states, res


def debug_capture(sync: OfdmSync, stream, device=None) -> dict:
    """One-shot capture of the synchronizer's internals for the strongest
    detected candidate in ``stream`` (the framesync debug dump of the
    reference).  ``stream`` is cut or zero-padded to ``block_size +
    overlap`` samples; a NumPy stream goes to ``device`` (the default
    device when ``None``).

    Returns NumPy values: ``metric`` (the metric the detector runs:
    ``_detect_metric_xcorr`` for the xcorr detector at levels 0 and 1, else
    ``_detect_metric``, kernel B3 at levels 1 and 2), ``detected``, ``n0``,
    ``cfo``, ``rssi``, ``header_valid``, ``H`` (the smoothed channel
    estimate ``[M]``), ``hsyms_eq`` (equalized header points) and
    ``psyms_eq`` (equalized payload points of this frame).  Never on the
    hot path."""
    from ..ops.iqfmt import iq_from_any
    if not isinstance(stream, torch.Tensor):
        stream = torch.as_tensor(np.asarray(stream),
                                 device=default_device(device))
    ext = iq_from_any(stream)
    need = sync.block_size + sync.overlap
    ext = torch.nn.functional.pad(ext, (0, max(0, need - ext.shape[-1])))
    ext = ext[None, :need]
    tables = sync_tables(sync, ext.device)
    detected, locs, c_at = _detect_candidates(sync, ext, tables)
    if sync.xcorr_detect and sync.use_pallas <= 1:
        metric = _detect_metric_xcorr(sync, ext, tables)
    else:
        metric, _ = _detect_metric(sync, ext)
    metric = metric[0].cpu().numpy()
    det, lc = detected[0].cpu().numpy(), locs[0].cpu().numpy()
    best = int(np.argmax(np.where(det, metric[lc], -1.0)))
    win = _window_gather(ext, torch.zeros(1, dtype=torch.int64,
                                          device=ext.device),
                         locs[:, best], sync.overlap)
    (_, points, _, _, _, _, _, hvalid, rssi, _, cfo,
     dbg) = _decode_window(sync, tables, win, c_at[:, best], debug=True)
    used = int(dbg["used_pts"][0])
    return {
        "metric": metric,
        "detected": bool(det[best]),
        "n0": int(lc[best]),
        "cfo": float(cfo[0]),
        "rssi": float(rssi[0]),
        "header_valid": bool(hvalid[0]),
        "H": dbg["H"][0].cpu().numpy(),
        "hsyms_eq": dbg["hsyms_eq"][0].cpu().numpy(),
        "psyms_eq": points[0, :max(used, 1)].cpu().numpy(),
    }
