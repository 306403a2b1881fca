"""GMSK framing — continuous-phase modulation TX + batched coherent RX.

Port of ``liquid_usrp_tpu/framing/gmskframe.py`` (``gmskframegen`` /
``gmskframesync``): Gaussian MSK frames at k samples/symbol with a 64-bit
alternating preamble, a 64-bit balanced PN syncword, the shared Golay
header and the shared payload codec as raw GMSK bits (1 bit/symbol; the
header's ``mod`` field is pinned to BPSK).  The host NumPy part
(``make_gmsk_params`` with its least-squares Laurent pulse fit, the
matched filter's frequency response and the detector taps) is copied
verbatim, so every parameter equals the JAX package's.

TX: differential precoding, NRZ, the Gaussian phase pulse as a ``conv1d``
(numpy's "same" alignment), and one float32 phase ``cumsum`` over the
frame.  The cumsum's rounding is the backend's: the port's waveform is held
to JAX's within a stated tolerance, not bit for bit.

RX, per extended window (``tail ++ block``):

1. the Laurent matched filter in the FFT domain;
2. the known template correlated coherently within 16-symbol segments at
   every offset (JAX: one dilated real convolution; here 16 shifted
   complex products, exact float32 on every device, no TF32), combined
   across segments by square law (``m1``) and differentially coherently
   (``m2``), normalized by a comb moving sum of ``|z|^2``;
3. the energy-balance and silence gates, non-max suppression and a top-k;
4. a decode batched over the candidates (where JAX ``vmap``s): parabolic
   timing, linear fractional-delay interpolation, CFO from a 512-point
   periodogram then a split-half slope, the ``(-j)^q`` derotation, the
   BPSK phase tracker, the header and the payload codec.

Each candidate reads its own window's ``z``, ``metric`` and samples by
(window, offset) index (JAX copies ``z[blk_of]`` per candidate), and every
gather clamps its index, as a JAX gather does.  The decode gate is a host
``if`` on ``detected.any()`` where JAX has a ``lax.cond``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import modem as modem_mod
from ..ops.corr import comb_moving_sum, find_candidates, next_pow2
from ..ops.iqfmt import iq_from_any
from ..utils.bits import unpack_bits
from ..utils.consts import on
from ..utils.device import default_device
from . import payload as payload_codec
from .flexframe_sync import FlexResults, _results, _row_gather
from .ofdm import FrameProps
from .payload import EXPANSION as _EXPANSION
from .phase_track import _cis, track_phase_bpsk

__all__ = [
    "GmskParams", "make_gmsk_params", "gmsk_assemble", "gmsk_frame_length",
    "GmskSync", "GmskSyncState", "make_gmsk_sync", "gmsk_sync_init",
    "gmsk_sync_block", "make_gmsk_sync_step", "gmsk_sync_blocks_batched",
    "gmsk_default_props",
]

PRE_BITS = 64
SYNC_BITS = 64
# detector coherence-segment length (symbols): coherent integration within
# a segment, noncoherent |.|^2 combining across segments (CFO tolerance
# ~ pi/(DETECT_SEG*k) rad/sample)
DETECT_SEG = 16
_NF = 512          # periodogram size of the CFO estimate


def gmsk_default_props() -> FrameProps:
    """GMSK app defaults: CRC16 + Hamming(7,4)."""
    from ..ops import crc as crc_mod
    from ..ops import fec as fec_mod
    return FrameProps(check=crc_mod.CRC_16, fec0=fec_mod.FEC_NONE,
                      fec1=fec_mod.FEC_HAMMING74,
                      mod=modem_mod.MOD_BPSK)


class GmskParams(NamedTuple):
    k: int                 # samples per symbol
    m: int                 # gaussian pulse semi-length (symbols)
    bt: float
    pulse: np.ndarray      # [2*k*m+1] float32, sums to 1 (phase pulse)
    template: np.ndarray   # [PRE_BITS + SYNC_BITS] float32 NRZ +-1
    c0: np.ndarray         # [Lc] complex64 empirical linear (Laurent) pulse
    a_ref: np.ndarray      # [PRE_BITS+SYNC_BITS] complex64 template symbols
    sgn: np.ndarray        # [PRE_BITS+SYNC_BITS] float32 derotated signs
    mf_lag: int            # sample lag: detector offset -> MF symbol center


def _gmsk_waveform_np(nrz: np.ndarray, k: int, pulse: np.ndarray):
    """Host-side reference modulator (mirrors gmsk_assemble)."""
    imp = np.zeros(len(nrz) * k)
    imp[::k] = nrz
    freq = np.convolve(imp, pulse, mode="same")
    phase = (np.pi / 2) * np.cumsum(freq)
    return np.exp(1j * phase)


def _fit_c0(k: int, m: int, pulse: np.ndarray) -> np.ndarray:
    """Empirical linearization: least-squares fit of the GMSK waveform as
    a linear PAM ``x[n] ~= sum_m a_m c0[n - m k]`` with the known CPM
    symbols ``a_m = exp(j pi/2 cumsum(nrz))``."""
    rng = np.random.default_rng(0xC0FEE)
    nb = 1024
    nrz = rng.choice(np.array([-1.0, 1.0]), nb)
    x = _gmsk_waveform_np(nrz, k, pulse)
    a = np.exp(1j * (np.pi / 2) * np.cumsum(nrz))
    a_up = np.zeros(nb * k, np.complex128)
    a_up[::k] = a
    Lc = (4 * m + 3) * k + 1
    off = Lc // 2
    cols = []
    for j in range(Lc):
        cols.append(np.roll(a_up, j - off))
    A = np.stack(cols, axis=1)
    rows = slice(Lc, nb * k - Lc)
    c0, *_ = np.linalg.lstsq(A[rows], x[rows], rcond=None)
    return c0


@functools.lru_cache(maxsize=None)
def make_gmsk_params(k: int = 2, m: int = 3, bt: float = 0.5) -> GmskParams:
    from ..ops.filter_design import gaussian_pulse
    rng = np.random.default_rng(0x6A5C0001)
    pre = np.array([1 - 2 * (i % 2) for i in range(PRE_BITS)], dtype=np.int8)
    # balanced PN syncword (zero sum => clean CFO estimation)
    sw = np.concatenate([np.ones(SYNC_BITS // 2), -np.ones(SYNC_BITS // 2)])
    rng.shuffle(sw)
    template = np.concatenate([pre, sw]).astype(np.float32)
    pulse = gaussian_pulse(k, m, bt)
    c0 = _fit_c0(k, m, pulse)
    n_t = PRE_BITS + SYNC_BITS
    S = np.cumsum(template.astype(np.float64))
    a_ref = np.exp(1j * (np.pi / 2) * S)
    # (S_n - n) is even for +-1 increments => a_ref * (-j)^n is +-1 real
    sgn = np.real(a_ref * (-1j) ** (np.arange(1, n_t + 1))).round()

    # calibrate the constant lag between the detector's peak offset and
    # the MF symbol centers (absorbs every alignment convention): run the
    # detector's own metric — the segmented-coherent MF correlation, the
    # SAME math as _front_end — on a clean frame to find n0_det, then
    # find the MF sampling lag that best matches a_ref
    pad = 16 * k
    frame_nrz = np.concatenate([template, rng.choice([-1.0, 1.0], 64)])
    x = np.concatenate([
        np.ones(pad, np.complex128),
        _gmsk_waveform_np(np.concatenate([frame_nrz, np.zeros(2 * m)]),
                          k, pulse)])
    mf = np.convolve(x, np.conj(c0[::-1]), mode="same")
    offs = np.arange(pad + 4 * k)
    wz = mf[offs[:, None] + k * np.arange(n_t)[None, :]]
    n_seg = n_t // DETECT_SEG
    u = (wz * np.conj(a_ref)[None, :]).reshape(-1, n_seg, DETECT_SEG)
    ez = (np.abs(wz) ** 2).reshape(-1, n_seg, DETECT_SEG).sum(-1)
    ea = (np.abs(a_ref) ** 2).reshape(n_seg, DETECT_SEG).sum(-1)
    num = (np.abs(u.sum(-1)) ** 2).sum(-1)
    den = np.maximum((ez * ea[None, :]).sum(-1), 1e-12)
    n0_det = int(np.argmax(num / den))
    best, mf_lag = -1.0, 0
    for lag in range(-4 * k, 4 * k + 1):
        idx = n0_det + lag + k * np.arange(n_t)
        if idx[0] < 0 or idx[-1] >= len(mf):
            continue
        v = abs(np.vdot(a_ref, mf[idx]))
        if v > best:
            best, mf_lag = v, lag
    return GmskParams(k=k, m=m, bt=bt,
                      pulse=pulse.astype(np.float32),
                      template=template,
                      c0=c0.astype(np.complex64),
                      a_ref=a_ref.astype(np.complex64),
                      sgn=sgn.astype(np.float32),
                      mf_lag=int(mf_lag))


def _frame_bits(props: FrameProps, header: torch.Tensor,
                payload: torch.Tensor) -> torch.Tensor:
    henc = payload_codec.encode_header(header, payload.shape[-1], props)
    penc = payload_codec.encode_payload(props, payload)
    return torch.cat([unpack_bits(henc), unpack_bits(penc)])


def data_bits_count(props: FrameProps, payload_len: int) -> int:
    return (payload_codec.HEADER_ENC_BYTES +
            payload_codec.payload_enc_bytes(props, payload_len)) * 8


def gmsk_frame_length(params: GmskParams, props: FrameProps,
                      payload_len: int) -> int:
    n_bits = PRE_BITS + SYNC_BITS + data_bits_count(props, payload_len)
    return (n_bits + 2 * params.m) * params.k


def gmsk_assemble(params: GmskParams, props: FrameProps,
                  header: torch.Tensor, payload: torch.Tensor,
                  expansion: int = payload_codec.EXPANSION,
                  rx_max_payload: int = None) -> torch.Tensor:
    """Assemble one GMSK burst -> complex64 ``[gmsk_frame_length]`` on
    ``header``'s device.  ``expansion``/``rx_max_payload`` describe the
    receiving sync's decode budget (see ``payload.check_budget``)."""
    dev = header.device
    payload = payload.to(dev)
    payload_codec.check_budget(props, payload.shape[-1], expansion,
                               rx_max_payload)
    bits = _frame_bits(props, header, payload)
    # differential precoding: the coherent receiver's derotated decision
    # j^(S_q - q) then equals (-1)^bit directly
    bits = bits ^ torch.cat([torch.zeros(1, dtype=bits.dtype, device=dev),
                             bits[:-1]])
    nrz = 1.0 - 2.0 * bits.to(torch.float32)
    sym = torch.cat([on(params.template, dev), nrz,
                     torch.zeros(2 * params.m, device=dev)])
    k = params.k
    # impulse train -> gaussian phase pulse -> pi/2-per-symbol phase ramp
    imp = torch.zeros(sym.shape[0] * k, device=dev)
    imp[::k] = sym
    # numpy "same" convolution: the full convolution (a correlation with
    # the flipped pulse) from offset (P - 1) // 2
    P = params.pulse.shape[0]
    full = torch.nn.functional.conv1d(
        imp.view(1, 1, -1), on(params.pulse, dev).flip(0).view(1, 1, -1),
        padding=P - 1).view(-1)
    freq = full[(P - 1) // 2:(P - 1) // 2 + imp.shape[0]]
    # pulse sums to 1, so each symbol contributes pi/2 * nrz total phase
    phase = (np.pi / 2) * torch.cumsum(freq, 0)
    return _cis(phase)


# ---------------------------------------------------------------------------
# synchronizer
# ---------------------------------------------------------------------------

class GmskSync(NamedTuple):
    params: GmskParams
    block_size: int
    max_payload: int
    max_frames: int
    threshold: float
    overlap: int
    max_bits: int            # header+payload bit budget
    dec_max: int
    enc_max: int
    fecs: tuple = payload_codec.PAYLOAD_FECS
    soft: bool = False       # soft-decision LLRs into Golay and conv FEC


class GmskSyncState(NamedTuple):
    tail: torch.Tensor       # [overlap] complex64 raw samples
    base: torch.Tensor       # int32 stream index of tail[0] (wraps at 2^31)


def make_gmsk_sync(params: GmskParams, block_size: int = 16384,
                   max_payload: int = 2048, max_frames: int = 8,
                   threshold: float = 0.38, enable_conv: bool = False,
                   soft: bool = False,
                   expansion: int = _EXPANSION) -> GmskSync:
    if expansion < 1:
        raise ValueError(f"expansion must be >= 1 (got {expansion})")
    dec_max = max_payload + 4
    enc_max = expansion * dec_max   # see payload.check_budget
    max_bits = (payload_codec.HEADER_ENC_BYTES + enc_max) * 8
    max_frame = (PRE_BITS + SYNC_BITS + max_bits + 4 * params.m) * params.k
    fecs = (payload_codec.PAYLOAD_FECS_FULL if enable_conv
            else payload_codec.PAYLOAD_FECS)
    # overlap margin beyond the frame: the +-4k mf_lag search plus the
    # fractional-delay interpolation read one sample past the last symbol
    # (24k covers every m)
    return GmskSync(params=params, block_size=block_size,
                    max_payload=max_payload, max_frames=max_frames,
                    threshold=threshold, overlap=max_frame + 24 * params.k,
                    max_bits=max_bits, dec_max=dec_max, enc_max=enc_max,
                    fecs=fecs, soft=bool(soft))


def gmsk_sync_init(sync: GmskSync, device=None) -> GmskSyncState:
    dev = default_device(device)
    return GmskSyncState(
        tail=torch.zeros(sync.overlap, dtype=torch.complex64, device=dev),
        base=torch.tensor(-sync.overlap, dtype=torch.int32, device=dev))


@functools.lru_cache(maxsize=None)
def _mf_freq_np(k: int, m: int, bt: float, nfft: int) -> np.ndarray:
    """Host-precomputed frequency response of the Laurent MF (conjugated,
    time-reversed ``c0``) for FFT-domain convolution."""
    p = make_gmsk_params(k, m, bt)
    return np.fft.fft(np.conj(p.c0[::-1]).astype(np.complex64), nfft)


@functools.lru_cache(maxsize=None)
def _detect_kernel_np(k: int, m: int, bt: float) -> np.ndarray:
    """Per-segment template-correlation conv kernels ``[2 n_seg, 2, D]``:
    output channel 2s / 2s+1 is Re/Im of segment s's correlation, input
    channels are Re/Im of the MF stream (complex conv decomposed into one
    real grouped conv)."""
    p = make_gmsk_params(k, m, bt)
    n_seg = (PRE_BITS + SYNC_BITS) // DETECT_SEG
    A = np.conj(p.a_ref.reshape(n_seg, DETECT_SEG))
    rhs = np.zeros((2 * n_seg, 2, DETECT_SEG), np.float32)
    rhs[0::2, 0] = A.real
    rhs[0::2, 1] = -A.imag
    rhs[1::2, 0] = A.imag
    rhs[1::2, 1] = A.real
    return rhs


@functools.lru_cache(maxsize=None)
def _segment_taps(k: int, m: int, bt: float) -> np.ndarray:
    """The detector taps as complex ``[n_seg, D]`` (``conj(a_ref)`` per
    segment), read back from :func:`_detect_kernel_np`'s real form."""
    rhs = _detect_kernel_np(k, m, bt)
    return (rhs[0::2, 0] + 1j * rhs[1::2, 0]).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _decode_tables(k: int, m: int, bt: float, n_all: int):
    """``(rot, sgn_known)``: the exact ``(-j)^q`` 4-cycle for ``q = 1 ..
    n_all`` and the template signs zero-padded to ``n_all``."""
    p = make_gmsk_params(k, m, bt)
    n_t = PRE_BITS + SYNC_BITS
    q = np.arange(1, n_all + 1)
    rot = np.array([1, -1j, -1, 1j], np.complex64)[q % 4]
    sgn_known = np.concatenate([p.sgn, np.zeros(n_all - n_t, np.float32)])
    return rot, sgn_known


def _front_end(sync: GmskSync, ext: torch.Tensor):
    """Laurent matched filter + segmented-coherent template correlation +
    candidate extraction for extended windows ``ext [R, L]``; returns
    ``(z, metric, detected, locs)``.

    The metric is ``sqrt(m1 m2)``: ``m1`` the per-segment Cauchy-Schwarz
    normalized square-law sum over segments, ``m2`` the differentially
    coherent sum of adjacent segments' products (a data-region sidelobe's
    per-segment phases are incoherent, so it collapses there).  Gated to 0
    where the adjacent-segment energy balance fails (a signal/silence seam)
    or the raw sample power is below ``1e-3`` of the window mean."""
    p = sync.params
    k = p.k
    L = ext.shape[-1]
    dev = ext.device
    Lc = p.c0.shape[0]
    nfft = next_pow2(L + Lc)
    H = on(_mf_freq_np(p.k, p.m, p.bt, nfft), dev)
    start = (Lc - 1) // 2
    z = torch.fft.ifft(torch.fft.fft(ext, nfft) * H)[..., start:start + L]
    z = z.to(torch.complex64)

    n_t = PRE_BITS + SYNC_BITS
    n_seg = n_t // DETECT_SEG
    region = sync.block_size
    n_metric = region + 2 * (k * 16) + 1   # region inset + NMS lookahead
    shift = DETECT_SEG * k
    w_out = n_metric + (n_seg - 1) * shift
    w_in = w_out + (DETECT_SEG - 1) * k
    zt = z[..., :w_in]
    # c_s[n] = sum_j conj(a_ref[s D + j]) z[n + s shift + j k], n < n_metric:
    # the segment rows of JAX's dilated convolution, as shifted products
    taps = on(_segment_taps(p.k, p.m, p.bt), dev)            # [n_seg, D]
    segs = zt.unfold(-1, n_metric + (DETECT_SEG - 1) * k, shift)
    c = torch.zeros((*zt.shape[:-1], n_seg, n_metric), dtype=torch.complex64,
                    device=dev)
    for j in range(DETECT_SEG):
        c = c + taps[:, j, None] * segs[..., j * k:j * k + n_metric]
    e_out = comb_moving_sum(zt.abs() ** 2, DETECT_SEG, k, w_out)
    ea = np.sum(np.abs(p.a_ref.reshape(n_seg, DETECT_SEG)) ** 2, axis=-1)
    num = torch.zeros((*zt.shape[:-1], n_metric), device=dev)
    den = torch.zeros_like(num)
    num2 = torch.zeros_like(num, dtype=torch.complex64)
    den2 = torch.zeros_like(num)
    prev_c = prev_e = None
    for s in range(n_seg):
        cs = c[..., s, :]
        es = float(ea[s]) * e_out[..., s * shift:s * shift + n_metric]
        num = num + cs.abs() ** 2
        den = den + es
        if prev_c is not None:
            num2 = num2 + cs * torch.conj(prev_c)
            den2 = den2 + torch.sqrt(torch.clamp(es * prev_e, min=0.0))
        prev_c, prev_e = cs, es
    m1 = num / torch.clamp(den, min=1e-12)
    m2 = num2.abs() / torch.clamp(den2, min=1e-12)
    metric = torch.sqrt(torch.clamp(m1 * m2, min=0.0))
    zero = torch.zeros_like(metric)
    # energy-balance gate: a partially-covered template span (a seam)
    # collapses den2
    metric = torch.where(den2 > 0.4 * den, metric, zero)
    # silence gate: require real signal power in the raw samples
    pwr = ext[..., :n_metric].abs() ** 2
    floor = 1e-3 * ((ext.abs() ** 2).mean(-1, keepdim=True) + 1e-12)
    metric = torch.where(pwr > floor, metric, zero)
    vals, locs = find_candidates(metric, k * 16, region, sync.threshold,
                                 sync.max_frames)
    return z, metric, vals > 0, locs


def _decode_candidates(sync: GmskSync, z, metric, ext, row_of, n0):
    """Decode candidates ``r`` at offsets ``n0 [R]`` of window
    ``row_of[r]`` of ``z``/``ext [rows, L]`` and ``metric [rows,
    n_metric]``.  Returns (user, payload points, plen, mod, f0, f1, check,
    hvalid, rssi, evm, cfo), each ``[R, ...]``."""
    p = sync.params
    k = p.k
    n_t = PRE_BITS + SYNC_BITS
    dev = z.device
    L = z.shape[-1]
    n0 = n0.to(torch.int64)
    # fractional timing via parabolic fit
    m_m1 = _row_gather(metric, row_of, n0 - 1)
    m_0 = _row_gather(metric, row_of, n0)
    m_p1 = _row_gather(metric, row_of, n0 + 1)
    den = m_m1 - 2 * m_0 + m_p1
    delta = torch.where(den.abs() > 1e-9, 0.5 * (m_m1 - m_p1) / den,
                        torch.zeros_like(den))
    delta = torch.clamp(delta, -0.5, 0.5)
    n_all = n_t + sync.max_bits
    pos = ((n0.to(torch.float32) + delta) + p.mf_lag)[:, None] + \
        k * torch.arange(n_all, dtype=torch.float32, device=dev)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, L - 2)
    frac = pos - i0.to(torch.float32)
    zs = _row_gather(z, row_of, i0) * (1 - frac) + \
        _row_gather(z, row_of, i0 + 1) * frac          # [R, n_all]
    rel = pos - pos[:, n_t // 2, None]
    # CFO, stage 1: the periodogram peak of u = zs conj(a_ref) (a complex
    # sinusoid at the residual CFO), with parabolic sub-bin interpolation
    # on wrap-indexed neighbours
    aref = torch.conj(on(p.a_ref, dev))
    u = zs[:, :n_t] * aref
    U2 = torch.fft.fft(u, _NF).abs() ** 2
    pk = torch.argmax(U2, -1, keepdim=True)
    um = torch.gather(U2, -1, torch.remainder(pk - 1, _NF))[:, 0]
    u0 = torch.gather(U2, -1, pk)[:, 0]
    up = torch.gather(U2, -1, torch.remainder(pk + 1, _NF))[:, 0]
    den1 = um - 2 * u0 + up
    dsub = torch.where(den1.abs() > 1e-12, 0.5 * (um - up) / den1,
                       torch.zeros_like(den1))
    dsub = torch.clamp(dsub, -0.5, 0.5)
    f = (pk[:, 0].to(torch.float32) + dsub) / _NF
    f = torch.where(f > 0.5, f - 1.0, f)        # cycles/symbol-sample
    dw1 = 2 * np.pi * f / k
    zs = zs * _cis(-(dw1[:, None] * rel))
    # stage 2: split-half phase slope
    u = zs[:, :n_t] * aref
    G1 = u[:, :n_t // 2].mean(-1)
    G2 = u[:, n_t // 2:].mean(-1)
    dw2 = torch.angle(G2 * torch.conj(G1)) / ((n_t // 2) * k)
    zs = zs * _cis(-(dw2[:, None] * rel))
    dw = dw1 + dw2
    G = (zs[:, :n_t] * aref).mean(-1)
    Gm = torch.clamp(G.abs(), min=1e-9)
    # derotate the pi/2-per-symbol CPM rotation: j^(S_q - q) is real (+-1)
    # for the precoded stream
    rot, sgn_known = _decode_tables(p.k, p.m, p.bt, n_all)
    y = zs * (torch.conj(G) / Gm)[:, None] * on(rot, dev)
    # blockwise phase tracking anchored to the known template signs
    corr_ph = track_phase_bpsk(y, on(sgn_known, dev), seg=32, n_iter=2)
    y = y * _cis(-corr_ph)
    samp = y.real / Gm[:, None]
    # amplitude/noise reference against the known template signs
    sgn = on(p.sgn, dev)
    amp = (samp[:, :n_t] * sgn).sum(-1) / n_t
    amp = torch.where(amp.abs() > 1e-9, amp, torch.ones_like(amp))
    pts = (samp / amp[:, None]).to(torch.complex64)   # pseudo-BPSK points
    data = pts[:, n_t:]
    nh = payload_codec.HEADER_ENC_BYTES * 8
    if sync.soft:
        # exact-ML Golay from the LLRs of the BPSK pseudo-points
        (user, plen, mod_f, f0, f1, check,
         hvalid) = payload_codec.decode_header_points_soft(
            data[:, :nh], sync.max_payload, len(sync.fecs))
    else:
        hbits = modem_mod.demodulate(modem_mod.MOD_BPSK,
                                     data[:, :nh]).to(torch.uint8)
        (user, plen, mod_f, f0, f1, check,
         hvalid) = payload_codec.decode_header(
            payload_codec.header_bits_to_bytes(hbits), sync.max_payload,
            len(sync.fecs))
    snr_est = 10.0 * torch.log10(torch.clamp(
        amp ** 2 / torch.clamp(((samp[:, :n_t] - amp[:, None] * sgn) ** 2)
                               .mean(-1), min=1e-9), min=1e-9))
    # RSSI averaged over the preamble-template span
    ridx = n0[:, None] + torch.arange(n_t * k, device=dev)
    rssi = 10.0 * torch.log10(torch.clamp(
        (_row_gather(ext, row_of, ridx).abs() ** 2).mean(-1), min=1e-12))
    return (user, data[:, nh:], plen, mod_f, f0, f1, check, hvalid, rssi,
            -snr_est, dw)


def _gated_decode(sync: GmskSync, z, metric, ext, gate: bool, row_of,
                  locs, rows=None):
    """Batched candidate decode of flat candidates ``locs [R]`` (window
    ``row_of[r]``); the 12-tuple of per-candidate results, zeros when
    ``gate`` is False (nothing detected).  ``rows`` (bool ``[R]``): the
    candidates whose conv/RS payload decodes (default all)."""
    R = locs.shape[0]
    dev = z.device
    if not gate:
        def zz(dt, *s):
            return torch.zeros((R, *s), dtype=dt, device=dev)
        i32, f32 = torch.int32, torch.float32
        return (zz(torch.uint8, payload_codec.HEADER_USER_BYTES),
                zz(torch.uint8, sync.max_payload), zz(i32), zz(i32), zz(i32),
                zz(i32), zz(i32), zz(torch.bool), zz(torch.bool), zz(f32),
                zz(f32), zz(f32))
    (user, ppts, plen, mod_f, f0, f1, check, hvalid, rssi, evm,
     cfo) = _decode_candidates(sync, z, metric, ext, row_of, locs)
    # GMSK payload is 1 bit/symbol regardless of the header mod field
    mod_bpsk = torch.full((R,), modem_mod.MOD_BPSK, dtype=torch.int32,
                          device=dev)
    decode_fn = (payload_codec.decode_payload_batch_soft if sync.soft
                 else payload_codec.decode_payload_batch)
    payload, pvalid = decode_fn(
        sync.enc_max, sync.dec_max, sync.max_payload, ppts, mod_bpsk, f0, f1,
        check, plen, hvalid, sync.fecs, rows=rows)
    return (user, payload, plen, mod_f, f0, f1, check, hvalid, pvalid, rssi,
            evm, cfo)


def gmsk_sync_block(sync: GmskSync, state: GmskSyncState,
                    block: torch.Tensor):
    """Process ``block_size`` samples (complex, or ``[2, bs]`` IQ planes)
    -> ``(state', FlexResults [max_frames])``: a batched dispatch of one
    block."""
    new_state, res = gmsk_sync_blocks_batched(sync, state,
                                              iq_from_any(block)[None])
    return new_state, FlexResults(*(v[0] for v in res))


def make_gmsk_sync_step(sync: GmskSync):
    """``step(state, block) -> (state', FlexResults)`` closure over one
    config (JAX jits this closure; the port runs it eagerly)."""
    def step(state: GmskSyncState, block: torch.Tensor):
        return gmsk_sync_block(sync, state, block)
    return step


def gmsk_sync_blocks_batched(sync: GmskSync, state: GmskSyncState,
                             blocks: torch.Tensor):
    """Multi-block batched dispatch: ``blocks [n_blocks, block_size]`` (or
    IQ planes ``[2, n_blocks, block_size]``) -> ``(state', FlexResults
    [n_blocks, max_frames])``.  The front end runs over every block's
    extended window (strided views of ``tail ++ blocks``) and every
    candidate decodes against its own window, so the detected rows equal a
    sequence of :func:`gmsk_sync_block` steps."""
    blocks = iq_from_any(blocks)
    n_blocks, bs = blocks.shape
    if bs != sync.block_size:
        raise ValueError(f"blocks of {bs} samples, sync expects "
                         f"{sync.block_size}")
    K = sync.max_frames
    dev = blocks.device
    full = torch.cat([state.tail, blocks.reshape(-1)])
    exts = full.unfold(0, sync.overlap + bs, bs)     # [n_blocks, overlap+bs]
    z, metric, detected, locs = _front_end(sync, exts)
    row_of = torch.arange(n_blocks, device=dev).repeat_interleave(K)
    decoded = _gated_decode(sync, z, metric, exts, bool(detected.any()),
                            row_of, locs.reshape(-1), detected.reshape(-1))
    t_base = state.base + (torch.arange(n_blocks, dtype=torch.int32,
                                        device=dev) * bs)[:, None]
    res = _results(detected, locs, t_base, decoded, (n_blocks, K))
    new_state = GmskSyncState(tail=full[full.shape[0] - sync.overlap:],
                              base=state.base + n_blocks * bs)
    return new_state, res
