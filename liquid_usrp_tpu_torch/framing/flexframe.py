"""Single-carrier flexible framing — format and generator (TX).

Port of ``liquid_usrp_tpu/framing/flexframe.py``: ``flexframegen``
bursts and the fixed ``framegen64`` Frame64 variant.

Format: 64 PN BPSK preamble symbols (detection, CFO, gain/phase
reference); the shared codec header (Golay(24,12) + CRC16, BPSK); the
shared codec payload with a PN BPSK pilot in every 16th slot; root
raised-cosine pulse shaping at ``k`` samples/symbol (k=2, beta=0.3,
semi-length 7).  The whole symbol vector runs through one polyphase
interpolating FIR.  The preamble and pilot PN come from the same NumPy
draws as in JAX, so the waveforms agree.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import crc as crc_mod
from ..ops import fec as fec_mod
from ..ops import fir as fir_mod
from ..ops import modem as modem_mod
from ..ops.filter_design import rrcos
from ..utils.bits import unpack_bits
from ..utils.consts import on
from . import payload as payload_codec
from .ofdm import FrameProps, default_props
from .payload import HEADER_BPS, HEADER_MOD

__all__ = [
    "FlexParams", "make_flex_params", "n_payload_slots", "slots_layout",
    "flex_frame_symbols", "flex_frame_length", "flex_assemble",
    "FrameProps", "default_props", "PILOT_SPACING", "PREAMBLE_SYMS",
    "FLEX_HEADER_USER", "FRAME64_HEADER_USER", "FRAME64_PAYLOAD",
    "frame64_props", "frame64_assemble", "FRAME64_LEN",
]

PREAMBLE_SYMS = 64
PILOT_SPACING = 16          # every 16th payload slot is a PN BPSK pilot
# the flexframe apps carry a 14-byte user header; frame64 and the other
# families use 8 bytes.  TX takes it from header.shape[-1]; the sync is
# built with it (FlexSync.header_user).
FLEX_HEADER_USER = 14


class FlexParams(NamedTuple):
    k: int                  # samples per symbol
    m: int                  # RRC semi-length (taps = 2*k*m+1)
    beta: float
    taps: np.ndarray        # [2*k*m+1] float32 RRC
    preamble: np.ndarray    # [PREAMBLE_SYMS] float32 +-1 PN BPSK
    pilot_pn: np.ndarray    # [1024] float32 +-1 pilot values by pilot index


@functools.lru_cache(maxsize=None)
def make_flex_params(k: int = 2, m: int = 7,
                     beta: float = 0.3) -> FlexParams:
    rng = np.random.default_rng(0xF1E40001)
    pre = rng.integers(0, 2, PREAMBLE_SYMS) * 2.0 - 1.0
    pilots = rng.integers(0, 2, 1024) * 2.0 - 1.0
    return FlexParams(
        k=k, m=m, beta=beta,
        taps=rrcos(k, m, beta).astype(np.float32) * np.sqrt(k),
        preamble=pre.astype(np.float32),
        pilot_pn=pilots.astype(np.float32))


def n_payload_slots(props: FrameProps, payload_len: int) -> int:
    """Payload section symbol slots (data + pilots)."""
    bps = modem_mod.bits_per_symbol(props.mod)
    n_data = -(-payload_codec.payload_enc_bytes(props, payload_len) * 8
               // bps)
    if modem_mod.is_differential(props.mod):
        n_data += 1           # leading DPSK phase-reference point
    # a pilot at every PILOT_SPACING-th slot
    return n_data + -(-n_data // (PILOT_SPACING - 1))


def slots_layout(n_slots: int):
    """Static (data_positions, pilot_positions) within the payload section."""
    pos = np.arange(n_slots)
    is_pilot = (pos % PILOT_SPACING) == 0
    return pos[~is_pilot], pos[is_pilot]


def flex_frame_symbols(params: FlexParams, props: FrameProps,
                       payload_len: int,
                       header_user: int = FLEX_HEADER_USER) -> int:
    return (PREAMBLE_SYMS + payload_codec.header_syms(header_user) +
            n_payload_slots(props, payload_len))


def flex_frame_length(params: FlexParams, props: FrameProps,
                      payload_len: int,
                      header_user: int = FLEX_HEADER_USER) -> int:
    """Total burst samples (symbols * k + interpolation flush tail)."""
    return flex_frame_symbols(params, props, payload_len,
                              header_user) * params.k + \
        2 * params.m * params.k


def flex_assemble(params: FlexParams, props: FrameProps,
                  header: torch.Tensor, payload: torch.Tensor,
                  expansion: int = payload_codec.EXPANSION,
                  rx_max_payload: int = None) -> torch.Tensor:
    """One burst -> complex64 ``[flex_frame_length]`` on the device of
    ``header``.  ``header.shape[-1]`` sets the user-header length (the
    receiving sync must be built with the same ``header_user``);
    ``expansion``/``rx_max_payload`` describe the receiver's decode budget
    (``payload.check_budget``)."""
    dev = header.device
    payload_len = payload.shape[-1]
    payload_codec.check_budget(props, payload_len, expansion,
                               rx_max_payload)
    # header symbols
    hdr_syms = payload_codec.header_syms(header.shape[-1])
    henc = payload_codec.encode_header(header, payload_len, props)
    hbits = unpack_bits(henc)
    pad = hdr_syms * HEADER_BPS - hbits.shape[-1]
    if pad > 0:
        hbits = torch.nn.functional.pad(hbits, (0, pad))
    hsyms = modem_mod.modulate(HEADER_MOD, modem_mod.bits_to_symbols(
        hbits[:hdr_syms * HEADER_BPS], HEADER_BPS))
    # payload symbols
    enc = payload_codec.encode_payload(props, payload.to(dev))
    bps = modem_mod.bits_per_symbol(props.mod)
    pbits = unpack_bits(enc)
    n_data = -(-pbits.shape[-1] // bps)
    pad = n_data * bps - pbits.shape[-1]
    if pad:
        pbits = torch.nn.functional.pad(pbits, (0, pad))
    psyms = modem_mod.modulate(props.mod,
                               modem_mod.bits_to_symbols(pbits, bps))
    if modem_mod.is_differential(props.mod):
        psyms = payload_codec.diff_encode_points(psyms)
    n_slots = n_payload_slots(props, payload_len)
    data_pos, pilot_pos = slots_layout(n_slots)
    section = torch.zeros(n_slots, dtype=torch.complex64, device=dev)
    n_put = min(len(data_pos), psyms.shape[-1])
    section[torch.as_tensor(data_pos[:n_put], device=dev)] = psyms[:n_put]
    # periodic pilot PN by pilot ordinal (modulo the table length)
    pil = on(params.pilot_pn, dev, torch.complex64)[
        torch.as_tensor(np.arange(len(pilot_pos)) % len(params.pilot_pn),
                        device=dev)]
    section[torch.as_tensor(pilot_pos, device=dev)] = pil
    syms = torch.cat([on(params.preamble, dev, torch.complex64), hsyms,
                      section])
    # interpolate, flushing the filter with 2m trailing zero symbols
    full = torch.nn.functional.pad(syms, (0, 2 * params.m))
    st = fir_mod.firinterp_init(len(params.taps), params.k, device=dev)
    _, samples = fir_mod.firinterp_block(params.taps, params.k, st, full)
    return samples.to(torch.complex64)


# ---------------------------------------------------------------------------
# Frame64: fixed 64-byte-payload format (framegen64/framesync64)
# ---------------------------------------------------------------------------

FRAME64_PAYLOAD = 64
FRAME64_HEADER_USER = 8     # framegen64's fixed 8-byte user header


def frame64_props() -> FrameProps:
    """Fixed Frame64 coding: CRC32 + Golay(24,12), QPSK."""
    return FrameProps(check=crc_mod.CRC_32, fec0=fec_mod.FEC_NONE,
                      fec1=fec_mod.FEC_GOLAY2412, mod=modem_mod.MOD_QPSK)


def frame64_assemble(params: FlexParams, header: torch.Tensor,
                     payload: torch.Tensor) -> torch.Tensor:
    """Fixed-format frame: 64-byte payload, constant length (FRAME64_LEN)."""
    if payload.shape[-1] != FRAME64_PAYLOAD:
        raise ValueError("frame64 payload must be exactly 64 bytes")
    if header.shape[-1] != FRAME64_HEADER_USER:
        raise ValueError("frame64 header must be exactly 8 bytes")
    return flex_assemble(params, frame64_props(), header, payload)


FRAME64_LEN = flex_frame_length(make_flex_params(), frame64_props(),
                                FRAME64_PAYLOAD,
                                header_user=FRAME64_HEADER_USER)
