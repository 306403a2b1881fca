"""OFDM flexible framing — shared format definition + frame generator (TX).

Port of ``liquid_usrp_tpu/framing/ofdm.py``.  The frame format is the JAX
package's: two S0 short-sync symbols (energy on every 4th subcarrier), one
S1 long-sync symbol, a Golay(24,12) + CRC16 header in BPSK, then the payload
(CRC -> fec0 -> fec1 -> modem) on the data subcarriers with per-symbol
PN-rotated BPSK pilots; every data symbol is IFFT(M) + cyclic prefix with a
raised-cosine taper.  The parameter builders are NumPy, copied verbatim so
every table equals the JAX one (the tests compare them).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import crc as crc_mod
from ..ops import fec as fec_mod
from ..ops import modem as modem_mod
from ..utils.bits import unpack_bits
from ..utils.consts import on
from . import payload as payload_codec
from .payload import (HEADER_BPS as _HEADER_BPS,
                      HEADER_MOD as _HEADER_MOD,
                      HEADER_SYMS, HEADER_USER_BYTES)

__all__ = [
    "OfdmParams", "FrameProps", "make_ofdm_params", "default_props",
    "assemble_frame", "assemble_frames", "frame_length",
    "payload_symbol_count",
    "header_symbol_count", "HEADER_USER_BYTES", "NUM_S0",
    "SCTYPE_NULL", "SCTYPE_PILOT", "SCTYPE_DATA",
]

NUM_S0 = 2                     # short-sync preamble symbols
MAX_PAYLOAD = 4096             # bytes; >> any reference default (1200)


class OfdmParams(NamedTuple):
    """Static frame format description (all host-side constants)."""
    M: int
    cp_len: int
    taper_len: int
    # subcarrier maps, FFT-order indices
    data_idx: np.ndarray       # [n_data] int
    pilot_idx: np.ndarray      # [n_pilot] int
    null_idx: np.ndarray       # [n_null] int
    s0_freq: np.ndarray        # [M] complex64 S0 frequency-domain symbol
    s1_freq: np.ndarray        # [M] complex64 S1 frequency-domain symbol
    s0_time: np.ndarray        # [M] complex64 (unit average power)
    s1_time: np.ndarray        # [M] complex64
    pilot_base: np.ndarray     # [n_pilot] float (+-1 BPSK per pilot carrier)
    pilot_pn: np.ndarray       # [127] float (+-1 per-symbol rotation PN)
    taper_win: np.ndarray      # [taper_len] float raised-cosine ramp


class FrameProps(NamedTuple):
    """Per-packet properties (the ofdmflexframegenprops surface:
    check/fec0/fec1/mod_scheme of the reference's include/ofdmtxrx.h)."""
    check: int = crc_mod.CRC_32
    fec0: int = fec_mod.FEC_NONE
    fec1: int = fec_mod.FEC_HAMMING128
    mod: int = modem_mod.MOD_QPSK


def default_props() -> FrameProps:
    """Library defaults (the reference's lib/ofdmtxrx.cc:79-83)."""
    return FrameProps()


def default_subcarrier_allocation(M: int):
    """Deterministic default allocation: DC null, ~10% edge guards, pilots
    every 7th active carrier (mirrors the reference default's structure)."""
    guard = max(1, int(round(M * 0.1)))
    null = {0}
    for g in range(-guard + 1, guard):
        null.add((M // 2 + g) % M)
    active = [k for k in range(M) if k not in null]
    # order active carriers by physical frequency (negative..positive)
    def freq_order(k):
        return k - M if k > M // 2 else k
    active_sorted = sorted(active, key=freq_order)
    pilots = set(active_sorted[::7])
    data = [k for k in active if k not in pilots]
    if len(pilots) < 2:
        raise ValueError("M too small for pilot allocation")
    return (np.array(sorted(data)), np.array(sorted(pilots)),
            np.array(sorted(null)))


# per-subcarrier type codes (the liquid OFDMFRAME_SCTYPE_* surface for
# the ofdmflexframegen_create(M, cp, taper, p, ...) allocation vector)
SCTYPE_NULL = 0
SCTYPE_PILOT = 1
SCTYPE_DATA = 2


def make_ofdm_params(M: int = 64, cp_len: int = 16,
                     taper_len: int = 4, alloc=None) -> OfdmParams:
    """Build OFDM frame parameters.

    ``alloc``: optional length-M per-subcarrier type vector
    (``SCTYPE_NULL``/``SCTYPE_PILOT``/``SCTYPE_DATA``) — the custom
    subcarrier-allocation surface of ``ofdmflexframegen_create``'s ``p``
    argument; ``None`` selects the deterministic default allocation
    (what the reference passes, lib/ofdmtxrx.cc:86-88).
    """
    if alloc is not None:
        alloc = tuple(int(v) for v in np.asarray(alloc).ravel())
    return _make_ofdm_params(M, cp_len, taper_len, alloc)


@functools.lru_cache(maxsize=None)
def _make_ofdm_params(M: int, cp_len: int, taper_len: int,
                      alloc) -> OfdmParams:
    if M < 8:
        raise ValueError("number of subcarriers must be at least 8")
    if M % 4:
        # the S0 detector relies on the exact period-M/4 time structure of
        # the short-sync symbol (energy on every 4th subcarrier); an M that
        # is not a multiple of 4 builds frames the synchronizer cannot
        # reliably detect.  All reference configs use multiples of 4.
        raise ValueError("number of subcarriers must be a multiple of 4")
    if not (0 < cp_len <= M):
        raise ValueError("cyclic prefix must be in (0, M]")
    if taper_len > cp_len:
        raise ValueError("taper length cannot exceed cyclic prefix")
    if alloc is None:
        if M < 12:
            # the M>=8 ctor check matches the reference's message, but
            # the default allocation needs >= 2 pilots among the active
            # carriers, which M=8 cannot provide; smaller grids need a
            # custom alloc
            raise ValueError(
                "default subcarrier allocation needs M >= 12 (only one "
                "pilot fits at M=8); pass a custom alloc= with >= 2 "
                "pilots for smaller grids")
        data_idx, pilot_idx, null_idx = default_subcarrier_allocation(M)
    else:
        # validation mirrors ofdmframe_validate_sctype semantics
        if len(alloc) != M:
            raise ValueError(f"allocation must have M={M} entries")
        a = np.asarray(alloc)
        if not np.isin(a, (SCTYPE_NULL, SCTYPE_PILOT, SCTYPE_DATA)).all():
            raise ValueError("allocation entries must be SCTYPE_NULL/"
                             "PILOT/DATA (0/1/2)")
        data_idx = np.nonzero(a == SCTYPE_DATA)[0]
        pilot_idx = np.nonzero(a == SCTYPE_PILOT)[0]
        null_idx = np.nonzero(a == SCTYPE_NULL)[0]
        if len(pilot_idx) < 2:
            raise ValueError("allocation needs at least 2 pilot "
                             "subcarriers (CPE slope tracking)")
        if len(data_idx) < 1:
            raise ValueError("allocation needs at least 1 data subcarrier")
        # S0 lives on every 4th non-null subcarrier: without enough of
        # them the period-M/4 detection metric has no signal to lock on
        n_s0 = sum(1 for k in range(0, M, 4) if a[k] != SCTYPE_NULL)
        if n_s0 < 2:
            raise ValueError("allocation nulls (almost) every 4th "
                             "subcarrier — the S0 detector needs >= 2 "
                             "active multiples-of-4")
    rng = np.random.default_rng(0x5EED0FD + M)

    # S0: PN QPSK on every 4th active subcarrier, boosted to unit time power
    s0 = np.zeros(M, dtype=np.complex128)
    s0_set = [k for k in range(0, M, 4)
              if k not in set(null_idx.tolist())]
    ph = rng.integers(0, 4, size=len(s0_set))
    s0[s0_set] = np.exp(1j * (np.pi / 2 * ph + np.pi / 4))
    s0 *= np.sqrt(M / max(len(s0_set), 1))       # unit avg power in time
    s0_time = np.fft.ifft(s0) * np.sqrt(M)       # scaled so E|s0_time|^2 ~ 1

    # S1: PN BPSK on all active subcarriers
    s1 = np.zeros(M, dtype=np.complex128)
    act = sorted(set(range(M)) - set(null_idx.tolist()))
    s1[act] = rng.integers(0, 2, size=len(act)) * 2.0 - 1.0
    s1 *= np.sqrt(M / len(act))
    s1_time = np.fft.ifft(s1) * np.sqrt(M)

    pilot_base = rng.integers(0, 2, size=len(pilot_idx)) * 2.0 - 1.0
    pilot_pn = rng.integers(0, 2, size=127) * 2.0 - 1.0

    t = np.arange(taper_len) + 1.0
    taper_win = 0.5 * (1.0 - np.cos(np.pi * t / (taper_len + 1)))

    return OfdmParams(
        M=M, cp_len=cp_len, taper_len=taper_len,
        data_idx=data_idx, pilot_idx=pilot_idx, null_idx=null_idx,
        s0_freq=s0.astype(np.complex64), s1_freq=s1.astype(np.complex64),
        s0_time=s0_time.astype(np.complex64),
        s1_time=s1_time.astype(np.complex64),
        pilot_base=pilot_base.astype(np.float32),
        pilot_pn=pilot_pn.astype(np.float32),
        taper_win=taper_win.astype(np.float32),
    )


# ---------------------------------------------------------------------------
# frame geometry
# ---------------------------------------------------------------------------

def payload_enc_bytes(props: FrameProps, payload_len: int) -> int:
    return payload_codec.payload_enc_bytes(props, payload_len)


def payload_symbol_count(params: OfdmParams, props: FrameProps,
                         payload_len: int) -> int:
    """Number of payload OFDM symbols."""
    n_data = len(params.data_idx)
    bps = modem_mod.bits_per_symbol(props.mod)
    n_mod = -(-payload_enc_bytes(props, payload_len) * 8 // bps)
    if modem_mod.is_differential(props.mod):
        n_mod += 1            # leading DPSK phase-reference point
    return -(-n_mod // n_data)


def header_symbol_count(params: OfdmParams) -> int:
    return -(-HEADER_SYMS // len(params.data_idx))


def frame_length(params: OfdmParams, props: FrameProps,
                 payload_len: int) -> int:
    """Total samples in an assembled frame."""
    M, cp = params.M, params.cp_len
    n_sym = header_symbol_count(params) + payload_symbol_count(
        params, props, payload_len)
    return (NUM_S0 + 1) * M + n_sym * (M + cp)


# ---------------------------------------------------------------------------
# TX
# ---------------------------------------------------------------------------

def _pilot_values(params: OfdmParams, sym_indices: torch.Tensor
                  ) -> torch.Tensor:
    """Pilot BPSK values for absolute data-symbol indices ``[..., n_sym]``
    -> float32 ``[..., n_sym, n_pilot]``."""
    dev = sym_indices.device
    pn = on(params.pilot_pn, dev)[sym_indices.to(torch.int64) %
                                  params.pilot_pn.shape[0]]
    return pn[..., None] * on(params.pilot_base, dev)


def _ofdm_modulate(params: OfdmParams, freq_syms: torch.Tensor
                   ) -> torch.Tensor:
    """Frequency-domain symbols [n_sym, M] -> time samples [n_sym*(M+cp)]
    with CP + taper."""
    M, cp, tp = params.M, params.cp_len, params.taper_len
    time_syms = torch.fft.ifft(freq_syms, dim=-1) * \
        torch.sqrt(torch.tensor(M, dtype=torch.float32))
    with_cp = torch.cat([time_syms[:, M - cp:], time_syms], dim=-1)
    if tp > 0:
        win = torch.cat([
            on(params.taper_win, freq_syms.device),
            torch.ones(M + cp - tp, dtype=torch.float32,
                       device=freq_syms.device)])
        with_cp = with_cp * win[None, :].to(with_cp.dtype)
    return with_cp.reshape(-1)


def _symbols_to_grid(params: OfdmParams, mod_syms: torch.Tensor,
                     n_ofdm_syms: int, first_sym_index: int) -> torch.Tensor:
    """Pack modem symbols onto the data carriers of ``n_ofdm_syms`` OFDM
    symbols (zero-padding the tail), add pilots -> [n_ofdm_syms, M]."""
    dev = mod_syms.device
    n_data = len(params.data_idx)
    pad = n_ofdm_syms * n_data - mod_syms.shape[-1]
    syms = torch.cat([mod_syms, torch.zeros(pad, dtype=mod_syms.dtype,
                                            device=dev)])
    grid = torch.zeros((n_ofdm_syms, params.M), dtype=torch.complex64,
                       device=dev)
    grid[:, on(params.data_idx, dev)] = syms.reshape(
        n_ofdm_syms, n_data).to(torch.complex64)
    sym_idx = first_sym_index + torch.arange(n_ofdm_syms, device=dev)
    grid[:, on(params.pilot_idx, dev)] = \
        _pilot_values(params, sym_idx).to(torch.complex64)
    return grid


def assemble_frame(params: OfdmParams, props: FrameProps,
                   header: torch.Tensor, payload: torch.Tensor,
                   expansion: int = payload_codec.EXPANSION,
                   rx_max_payload: int = None) -> torch.Tensor:
    """Assemble a complete frame -> complex64 ``[frame_length]``.

    ``header``: uint8 [8]; ``payload``: uint8 [payload_len].  The frame is
    built on ``header``'s device.  ``expansion``/``rx_max_payload``
    describe the receiving sync's decode budget (see
    ``payload.check_budget``)."""
    dev = header.device
    payload = payload.to(dev)
    payload_len = payload.shape[-1]
    payload_codec.check_budget(props, payload_len, expansion,
                               rx_max_payload)
    # --- header ---
    hbits = unpack_bits(payload_codec.encode_header(header, payload_len,
                                                    props))
    pad = HEADER_SYMS * _HEADER_BPS - hbits.shape[-1]
    hbits = torch.nn.functional.pad(hbits, (0, pad))
    hsyms = modem_mod.modulate(
        _HEADER_MOD, modem_mod.bits_to_symbols(hbits, _HEADER_BPS))
    n_hsym = header_symbol_count(params)
    # --- payload ---
    enc = payload_codec.encode_payload(props, payload)
    bps = modem_mod.bits_per_symbol(props.mod)
    pbits = unpack_bits(enc)
    n_mod = -(-pbits.shape[-1] // bps)
    pbits = torch.nn.functional.pad(pbits, (0, n_mod * bps -
                                            pbits.shape[-1]))
    psyms = modem_mod.modulate(props.mod,
                               modem_mod.bits_to_symbols(pbits, bps))
    if modem_mod.is_differential(props.mod):
        psyms = payload_codec.diff_encode_points(psyms)
    n_psym = payload_symbol_count(params, props, payload_len)
    # --- grids & time-domain ---
    hgrid = _symbols_to_grid(params, hsyms, n_hsym, 0)
    pgrid = _symbols_to_grid(params, psyms, n_psym, n_hsym)
    body = _ofdm_modulate(params, torch.cat([hgrid, pgrid], dim=0))
    s0 = on(params.s0_time, dev)
    preamble = torch.cat([s0.repeat(NUM_S0), on(params.s1_time, dev)])
    return torch.cat([preamble, body])


def assemble_frames(params: OfdmParams, props: FrameProps,
                    headers: torch.Tensor, payloads: torch.Tensor,
                    expansion: int = payload_codec.EXPANSION,
                    rx_max_payload: int = None) -> torch.Tensor:
    """Batched assembly: ``[B, 8]`` headers + ``[B, P]`` payloads ->
    ``[B, frame_length]`` (one :func:`assemble_frame` per row, where JAX
    ``vmap``s; the frames of one props share a length)."""
    return torch.stack([assemble_frame(params, props, h, p,
                                       expansion=expansion,
                                       rx_max_payload=rx_max_payload)
                        for h, p in zip(headers, payloads)])
