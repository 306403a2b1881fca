"""Shared payload/header codec (hard- and soft-decision paths).

Port of ``liquid_usrp_tpu/framing/payload.py``: the static header codec
(Golay(24,12) + CRC16 + PN scramble) and the runtime-property payload
decode (constellation selected per frame from a padded table stack, FEC by
a masked select over the scheme set on static max-size buffers, CRC over a
per-frame length).  Every function is written batched: a leading candidate
axis replaces the JAX code's ``vmap``.

Exactness rules carried over from the JAX code:

* nearest-point decisions use ``(xr-tr)**2 + (xi-ti)**2`` in float32 and
  keep the first minimum on ties, so decisions are bit-identical; on the
  card one launch of the hand-written kernel ``csrc/nearest.cu`` makes
  them (:func:`_nearest_sym`), on the CPU the chunked loop beside it;
* every ``lax.dynamic_slice`` clamps its start into ``[0, len - size]``;
  the port's gathers clamp the same way.

The convolutional and RS schemes (``PAYLOAD_FECS_FULL``) decode in the
batched path only the rows that carry them, each such row whether its
header is valid or not, so every row's bytes equal JAX's; a receiver
narrows that to its detected candidates, whose bytes are the ones read
(see :func:`_fec_batch`).  The soft-decision path
(:func:`generic_demod_soft`, :func:`decode_header_soft`,
:func:`decode_payload_batch_soft`) feeds
max-log bit LLRs to the exact-ML Golay header decoder and to the soft
Viterbi of the convolutional payload codes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import crc as crc_mod
from ..ops import fec as fec_mod
from ..ops import kernels
from ..ops import modem as modem_mod
from ..utils.bits import pack_bits, unpack_bits
from ..utils.consts import on
from ..utils.profiling import count

__all__ = [
    "PAYLOAD_FECS", "PAYLOAD_FECS_FULL", "PAYLOAD_MODS", "EXPANSION",
    "HEADER_USER_BYTES",
    "HEADER_DEC_BYTES", "HEADER_ENC_BYTES", "HEADER_MOD", "HEADER_BPS",
    "HEADER_SYMS", "header_dec_bytes", "header_enc_bytes", "header_syms",
    "scramble", "encode_header", "decode_header", "header_bits_to_bytes",
    "encode_payload", "payload_enc_bytes", "check_budget",
    "required_expansion", "diff_encode_points", "generic_demod_bits",
    "crc_check_dynamic", "payload_points_used", "payload_evm_mse",
    "frame_evm_db", "fec_decode_switch", "decode_payload",
    "decode_payload_batch", "generic_demod_soft", "decode_header_soft",
    "decode_header_points_soft", "decode_payload_batch_soft",
]

PAYLOAD_FECS = (
    fec_mod.FEC_NONE, fec_mod.FEC_REP3, fec_mod.FEC_REP5,
    fec_mod.FEC_HAMMING74, fec_mod.FEC_HAMMING84, fec_mod.FEC_HAMMING128,
    fec_mod.FEC_GOLAY2412, fec_mod.FEC_SECDED2216, fec_mod.FEC_SECDED3932,
    fec_mod.FEC_SECDED7264,
)
# extended set with the Viterbi and RS branches (opt-in per sync); an
# id-ordered prefix of the scheme enum, as PAYLOAD_FECS
PAYLOAD_FECS_FULL = PAYLOAD_FECS + (fec_mod.FEC_CONV_V27,
                                    fec_mod.FEC_CONV_V29, fec_mod.FEC_RS8)
PAYLOAD_MODS = tuple(range(50))     # every modem scheme id
EXPANSION = 3                       # worst supported FEC expansion budget
_MAX_CONST = 256
_DEMOD_CHUNK = 16
_IS_DIFF = np.array([modem_mod.is_differential(s) for s in PAYLOAD_MODS])
_BPS = np.array([modem_mod.bits_per_symbol(s) for s in PAYLOAD_MODS],
                np.int64)

HEADER_USER_BYTES = 8
HEADER_FEC = fec_mod.FEC_GOLAY2412
HEADER_MOD = modem_mod.MOD_BPSK
HEADER_BPS = 1


def header_dec_bytes(user_bytes: int = HEADER_USER_BYTES) -> int:
    """user bytes + [len u16 | mod | fec0 | fec1 | check] + CRC16."""
    return user_bytes + 6 + 2


def header_enc_bytes(user_bytes: int = HEADER_USER_BYTES) -> int:
    return fec_mod.encoded_length(HEADER_FEC, header_dec_bytes(user_bytes))


def header_syms(user_bytes: int = HEADER_USER_BYTES) -> int:
    return (header_enc_bytes(user_bytes) * 8 + HEADER_BPS - 1) // HEADER_BPS


HEADER_DEC_BYTES = header_dec_bytes()
HEADER_ENC_BYTES = header_enc_bytes()
HEADER_SYMS = header_syms()


@functools.lru_cache(maxsize=None)
def _scramble_np(n: int, salt: int) -> np.ndarray:
    """Deterministic PN byte sequence (same generator as the JAX code)."""
    rng = np.random.default_rng(0x5C4A3B1E + salt)
    return rng.integers(0, 256, size=n, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _pn_signs(n: int, salt: int) -> np.ndarray:
    """float32 ``[n*8]``: -1 where a bit of the PN sequence is 1, else 1
    (descrambles an LLR stream by sign flips)."""
    bits = np.unpackbits(_scramble_np(n, salt)).astype(np.float32)
    return 1.0 - 2.0 * bits


def scramble(data: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """XOR with the PN sequence (involutive)."""
    return data ^ on(_scramble_np(data.shape[-1], salt), data.device)


@functools.lru_cache(maxsize=None)
def _stacked_tables() -> np.ndarray:
    tabs = np.full((len(PAYLOAD_MODS), _MAX_CONST), 1e6 + 0j,
                   dtype=np.complex64)
    for s in PAYLOAD_MODS:
        t = modem_mod._table_np(s)
        tabs[s, : len(t)] = t.astype(np.complex64)
    return tabs


# ---------------------------------------------------------------------------
# header
# ---------------------------------------------------------------------------

def encode_header(header: torch.Tensor, payload_len: int, props
                  ) -> torch.Tensor:
    """User bytes + [len u16 | mod | fec0 | fec1 | check] -> encoded
    (scrambled) header bytes."""
    internal = torch.tensor([
        (payload_len >> 8) & 0xFF, payload_len & 0xFF,
        props.mod & 0xFF, props.fec0 & 0xFF, props.fec1 & 0xFF,
        props.check & 0xFF], dtype=torch.uint8, device=header.device)
    dec = torch.cat([header.to(torch.uint8), internal])
    dec = crc_mod.crc_append(crc_mod.CRC_16, dec)
    return scramble(fec_mod.fec_encode(HEADER_FEC, dec), salt=1)


def decode_header(hbytes: torch.Tensor, max_payload: int,
                  n_fecs: int = len(PAYLOAD_FECS),
                  user_bytes: int = HEADER_USER_BYTES):
    """Encoded header bytes ``[..., enc]`` -> (user, plen, mod, f0, f1,
    check, valid), each with the leading shape.  Fields are clamped into
    range so they are safe as indices even when ``valid`` is False."""
    dec = fec_mod.fec_decode(HEADER_FEC, scramble(hbytes, salt=1),
                             header_dec_bytes(user_bytes))
    return _header_fields(dec, max_payload, n_fecs, user_bytes)


def decode_header_soft(hllrs: torch.Tensor, max_payload: int,
                       n_fecs: int = len(PAYLOAD_FECS),
                       user_bytes: int = HEADER_USER_BYTES):
    """Soft-decision header decode from channel bit LLRs ``[..., >=
    enc*8]`` (positive => bit 1, the :func:`generic_demod_soft` layout):
    the scrambler is undone by flipping each LLR's sign where its PN bit
    is 1, then every Golay(24,12) block is decoded exact-ML against all
    4096 codewords (``fec.golay_decode_soft``).  Same returns as
    :func:`decode_header`."""
    enc_b = header_enc_bytes(user_bytes)
    dec_b = header_dec_bytes(user_bytes)
    need = enc_b * 8
    L = hllrs[..., :need] * on(_pn_signs(enc_b, 1), hllrs.device)
    nblocks = -(-(dec_b * 8) // 12)
    lead = L.shape[:-1]
    mbits = fec_mod.golay_decode_soft(
        L[..., :nblocks * 24].reshape(*lead, nblocks, 24))
    dec = pack_bits(mbits.reshape(*lead, nblocks * 12)[..., :dec_b * 8])
    return _header_fields(dec, max_payload, n_fecs, user_bytes)


def decode_header_points_soft(hpts: torch.Tensor, max_payload: int,
                              n_fecs: int = len(PAYLOAD_FECS),
                              user_bytes: int = HEADER_USER_BYTES):
    """Soft header decode of equalized BPSK header points ``[R, >= enc*8]``
    (one point a bit): their LLRs (:func:`generic_demod_soft` on a 16-entry
    table, which holds BPSK: the padding never wins a minimum) through
    :func:`decode_header_soft`."""
    mod = torch.full(hpts.shape[:1], HEADER_MOD, dtype=torch.int32,
                     device=hpts.device)
    hllrs = generic_demod_soft(hpts, mod, header_enc_bytes(user_bytes) * 8,
                               n_table=16)
    return decode_header_soft(hllrs, max_payload, n_fecs, user_bytes)


def _header_fields(dec: torch.Tensor, max_payload: int, n_fecs: int,
                   user_bytes: int = HEADER_USER_BYTES):
    ok = crc_mod.crc_check(crc_mod.CRC_16, dec)
    user = dec[..., :user_bytes]
    i32 = torch.int32
    plen = (dec[..., user_bytes].to(i32) << 8) | dec[..., user_bytes + 1].to(i32)
    mod = dec[..., user_bytes + 2].to(i32)
    f0 = dec[..., user_bytes + 3].to(i32)
    f1 = dec[..., user_bytes + 4].to(i32)
    check = dec[..., user_bytes + 5].to(i32)
    valid = ok & (mod < len(PAYLOAD_MODS)) & (f0 < n_fecs) & \
        (f1 < n_fecs) & (check <= 2) & (plen <= max_payload)
    return (user, torch.clamp(plen, 0, max_payload),
            torch.clamp(mod, 0, len(PAYLOAD_MODS) - 1),
            torch.clamp(f0, 0, n_fecs - 1), torch.clamp(f1, 0, n_fecs - 1),
            torch.clamp(check, 0, 2), valid)


def header_bits_to_bytes(hbits: torch.Tensor,
                         user_bytes: int = HEADER_USER_BYTES) -> torch.Tensor:
    """Demodulated header bit stream ``[..., n]`` -> encoded header bytes."""
    need = header_enc_bytes(user_bytes) * 8
    if hbits.shape[-1] < need:
        hbits = torch.nn.functional.pad(hbits, (0, need - hbits.shape[-1]))
    return pack_bits(hbits[..., :need])


# ---------------------------------------------------------------------------
# payload: TX
# ---------------------------------------------------------------------------

def payload_enc_bytes(props, payload_len: int) -> int:
    n = payload_len + crc_mod.crc_width_bytes(props.check)
    n = fec_mod.encoded_length(props.fec0, n)
    return fec_mod.encoded_length(props.fec1, n)


def required_expansion(props, payload_len: int) -> int:
    """Smallest ``expansion`` budget that fits this props combination for
    any conforming receiver (worst case ``max_payload == payload_len``)."""
    dec = payload_len + 4
    need = payload_enc_bytes(props, payload_len)
    return max(EXPANSION, -(-need // max(dec, 1)))


def check_budget(props, payload_len: int, expansion: int = EXPANSION,
                 rx_max_payload: int = None):
    """Raise if this mod/FEC combination overflows the RX decode budget of
    ``expansion * (max_payload + 4)`` bytes (see the JAX docstring)."""
    if expansion < 1:
        raise ValueError(f"expansion must be >= 1 (got {expansion})")
    if rx_max_payload is not None and payload_len > rx_max_payload:
        raise ValueError(
            f"{payload_len}-byte payload exceeds the receiver's "
            f"max_payload={rx_max_payload}")
    rx_max = payload_len if rx_max_payload is None else rx_max_payload
    need = payload_enc_bytes(props, payload_len)
    budget = expansion * (rx_max + 4)
    if need > budget:
        raise ValueError(
            f"fec0={fec_mod.fec_name(props.fec0)} + "
            f"fec1={fec_mod.fec_name(props.fec1)} encodes a "
            f"{payload_len}-byte payload to {need} bytes — beyond the "
            f"expansion={expansion} receive budget of {budget} bytes")


def encode_payload(props, payload: torch.Tensor) -> torch.Tensor:
    """payload -> CRC -> fec0 -> fec1 -> scramble (static length)."""
    enc = crc_mod.crc_append(props.check, payload.to(torch.uint8))
    enc = fec_mod.fec_encode(props.fec0, enc)
    enc = fec_mod.fec_encode(props.fec1, enc)
    return scramble(enc, salt=2)


def diff_encode_points(increments: torch.Tensor) -> torch.Tensor:
    """TX side of DPSK: prepend the unit reference point to the cumulative
    rotation of the phase increments."""
    one = torch.ones((1,), dtype=increments.dtype, device=increments.device)
    return torch.cat([one, torch.cumprod(increments, dim=0)])


# ---------------------------------------------------------------------------
# payload: RX (batched over a leading candidate axis)
# ---------------------------------------------------------------------------

def _diff_effective(x: torch.Tensor, mod: torch.Tensor):
    """(x_eff, src_offset) for points ``[K, n]`` and schemes ``[K]``:
    differential schemes demap the normalized lag products ``x[k]
    conj(x[k-1])`` and their data starts after the reference point."""
    is_diff = on(_IS_DIFF, x.device)[mod.to(torch.int64)]
    prev = torch.cat([torch.ones_like(x[..., :1]), x[..., :-1]], dim=-1)
    d = x * torch.conj(prev)
    d = d / torch.clamp(torch.abs(d), min=1e-12)
    x_eff = torch.where(is_diff[..., None], d, x)
    return x_eff, is_diff.to(torch.int64)


def _nearest_sym(x: torch.Tensor, table: torch.Tensor):
    """``(argmin_c, min_c) |x - table[c]|^2`` per point: ``x [K, n]``
    against per-row tables ``table [K, C]`` -> (int64 ``[K, n]``, float32
    ``[K, n]``), first minimum on ties.  A CPU tensor runs
    :func:`_nearest_sym_plain`; a CUDA tensor launches ``csrc/nearest.cu``
    (complex64, ``1 <= C <= 256``) or raises, with the plain version's
    results bit for bit, counted in ``kernels.launches["nearest"]``.
    Counts the (point, entry) pairs compared as ``nearest_entries``."""
    C = table.shape[-1]
    count("nearest_entries", x.numel() * C)
    if x.device.type == "cpu":
        return _nearest_sym_plain(x, table)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if x.dtype != torch.complex64 or table.dtype != torch.complex64:
        raise TypeError(f"points and table must be complex64, got "
                        f"{x.dtype} and {table.dtype}")
    if table.shape[:-1] != x.shape[:-1] or not 1 <= C <= _MAX_CONST:
        raise ValueError(f"points {tuple(x.shape)} against a table "
                         f"{tuple(table.shape)}: one row of 1-{_MAX_CONST} "
                         f"entries a row of points")
    arg = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    best = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if not x.numel():
        return arg, best
    n = x.shape[-1]
    pts = x.reshape(-1, n).contiguous()
    tab = table.reshape(-1, C).contiguous()
    K = pts.shape[0]
    kernels._launch("nearest_launch", pts, dict(rows=K, points=n, entries=C),
                    pts.data_ptr(), K, n, tab.data_ptr(), C, arg.data_ptr(),
                    best.data_ptr())
    kernels.launches["nearest"] += 1
    return arg, best


def _nearest_sym_plain(x: torch.Tensor, table: torch.Tensor):
    """Plain PyTorch version of :func:`_nearest_sym`: distances
    ``(xr-tr)**2 + (xi-ti)**2`` in float32 in chunks of 16 entries,
    ascending, first minimum on ties (``argmin`` within a chunk, strict
    ``<`` across chunks) — the JAX decision rule."""
    C = table.shape[-1]
    xr, xi = x.real[..., None], x.imag[..., None]
    tr, ti = table.real[..., None, :], table.imag[..., None, :]
    best = torch.full(x.shape, 1e30, dtype=torch.float32, device=x.device)
    arg = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for c0 in range(0, C, _DEMOD_CHUNK):
        c1 = c0 + _DEMOD_CHUNK
        d = (xr - tr[..., c0:c1]) ** 2 + (xi - ti[..., c0:c1]) ** 2
        a = torch.argmin(d, dim=-1)
        m = torch.gather(d, -1, a[..., None])[..., 0]
        upd = m < best
        best = torch.where(upd, m, best)
        arg = torch.where(upd, a + c0, arg)
    return arg, best


def _nearest_point(x: torch.Tensor, table: torch.Tensor):
    """``(dec, dmin)``: the nearest constellation point (value) per
    sample, by the same rule as :func:`_nearest_sym`."""
    sym, dmin = _nearest_sym(x, table)
    return torch.gather(table, -1, sym), dmin


def _bits_from_syms(sym: torch.Tensor, off: torch.Tensor, bps: torch.Tensor,
                    max_bits: int) -> torch.Tensor:
    """Symbol stream ``[K, n]`` -> MSB-first bits ``[K, max_bits]`` for
    per-row ``bps`` and DPSK reference offset ``off`` (0/1).  Bit ``j``
    reads symbol ``j // bps + off``; symbols past the end read as zero (the
    JAX form's zero padding)."""
    n = sym.shape[-1]
    j = torch.arange(max_bits, device=sym.device)
    b = bps.to(torch.int64)[..., None]
    src = j // b + torch.clamp(off.to(torch.int64), 0, 1)[..., None]
    vals = torch.gather(sym.to(torch.int64), -1, torch.clamp(src, max=n - 1))
    vals = torch.where(src < n, vals, torch.zeros_like(vals))
    return ((vals >> (b - 1 - j % b)) & 1).to(torch.uint8)


def generic_demod_bits(x: torch.Tensor, mod: torch.Tensor, max_bits: int,
                       n_table: int = _MAX_CONST):
    """Demap points ``[K, n]`` with per-row schemes ``[K]`` -> (bits
    ``[K, max_bits]``, bps ``[K]``).  ``n_table`` truncates the padded
    table scan (exact whenever the scheme's constellation fits)."""
    x, off = _diff_effective(x, mod)
    m = mod.to(torch.int64)
    table = on(_stacked_tables(), x.device)[m][..., :n_table]
    sym, _ = _nearest_sym(x, table)
    bps = on(_BPS, x.device)[m]
    return _bits_from_syms(sym, off, bps, max_bits), bps


@functools.lru_cache(maxsize=None)
def _bit_masks() -> np.ndarray:
    """[n_schemes, 256, 8] bit of each constellation index, MSB-first per
    scheme (slot k = bit (bps-1-k)); zero beyond bps."""
    out = np.zeros((len(PAYLOAD_MODS), _MAX_CONST, 8), dtype=np.float32)
    for s in PAYLOAD_MODS:
        bps = modem_mod.bits_per_symbol(s)
        M = 1 << bps
        for c in range(M):
            for k in range(bps):
                out[s, c, k] = (c >> (bps - 1 - k)) & 1
    return out


_SOFT_INF = 1e12      # the JAX package's "no such point" distance


def generic_demod_soft(x: torch.Tensor, mod: torch.Tensor, max_bits: int,
                       n_table: int = _MAX_CONST) -> torch.Tensor:
    """Max-log per-bit LLRs for per-row schemes: points ``[K, n]``, schemes
    ``[K]`` -> float32 ``[K, max_bits]`` laid out like
    :func:`generic_demod_bits` (positive => bit 1): ``llr[j] =
    llr_pts[j // bps + off, j % bps]``, zeros past the end of the stream.

    The per-bit minima run over the padded table in chunks of 16 entries,
    each chunk one ``[K, n, 16]`` distance tile and its masked ``[K, n, 16,
    8]`` form reduced at once: the unchunked ``[K, n, 256, 8]`` at a
    flexframe dispatch (32 x 52,533 points) would be 13.8 GB.  Padding
    entries sit at ``1e6+0j`` and a bit with no candidate reads 1e12, as in
    JAX, so the padded LLR slots equal JAX's.  ``n_table`` truncates the
    table (exact whenever the scheme fits).  Counts the (point, entry)
    pairs compared as ``nearest_entries``."""
    x, off = _diff_effective(x, mod)
    m = mod.to(torch.int64)
    dev = x.device
    table = on(_stacked_tables(), dev)[m][..., :n_table]          # [K, C]
    count("nearest_entries", x.numel() * table.shape[-1])
    is1 = on(_bit_masks(), dev)[m][..., :n_table, :] > 0.5       # [K, C, 8]
    xr, xi = x.real[..., None], x.imag[..., None]
    inf = torch.tensor(_SOFT_INF, dtype=torch.float32, device=dev)
    d0 = torch.full((*x.shape, 8), _SOFT_INF, dtype=torch.float32,
                    device=dev)
    d1 = d0.clone()
    for c0 in range(0, table.shape[-1], _DEMOD_CHUNK):
        c1 = c0 + _DEMOD_CHUNK
        d = ((xr - table.real[..., None, c0:c1]) ** 2 +
             (xi - table.imag[..., None, c0:c1]) ** 2)[..., None]
        b = is1[:, None, c0:c1, :]                    # [K, 1, ck, 8]
        d0 = torch.minimum(d0, torch.where(b, inf, d).amin(-2))
        d1 = torch.minimum(d1, torch.where(b, d, inf).amin(-2))
    llr_pts = (d0 - d1).reshape(x.shape[0], -1)       # [K, n * 8]
    n = x.shape[-1]
    j = torch.arange(max_bits, device=dev)
    bps = on(_BPS, dev)[m][..., None]
    src = j // bps + torch.clamp(off, 0, 1)[..., None]
    idx = torch.clamp(src, max=n - 1) * 8 + j % bps
    vals = torch.gather(llr_pts, -1, idx)
    return torch.where(src < n, vals, torch.zeros_like(vals))


def crc_check_dynamic(check: torch.Tensor, buf: torch.Tensor,
                      plen: torch.Tensor) -> torch.Tensor:
    """Validate CRC over ``buf[:plen]`` against ``buf[plen:plen+w]`` per
    row (scheme per row; both CRCs computed, ``check`` selects)."""
    n = buf.shape[-1]
    plen = plen.to(torch.int64)

    def one(scheme):
        w = crc_mod.crc_width_bytes(scheme)
        got = crc_mod.crc_compute_masked(scheme, buf, plen)
        start = torch.clamp(plen, 0, n - w)          # dynamic_slice clamp
        idx = start[..., None] + torch.arange(w, device=buf.device)
        tail = torch.gather(buf, -1, idx).to(torch.int64)
        shifts = torch.arange(w - 1, -1, -1, device=buf.device) * 8
        return got == (tail << shifts).sum(-1)

    ok16 = one(crc_mod.CRC_16)
    ok32 = one(crc_mod.CRC_32)
    return torch.where(check == 0, torch.ones_like(ok16),
                       torch.where(check == 1, ok16, ok32))


@functools.lru_cache(maxsize=None)
def _enc_len_table(fecs: tuple, max_n: int) -> np.ndarray:
    """[len(fecs), max_n+1] encoded-length lookup."""
    t = np.zeros((len(fecs), max_n + 1), np.int64)
    for i, s in enumerate(fecs):
        for n in range(max_n + 1):
            t[i, n] = fec_mod.encoded_length(s, n)
    return t


def payload_points_used(fecs: tuple, dec_max: int, enc_max: int,
                        plen, mod, f0, f1, check) -> torch.Tensor:
    """Per-row count of constellation points the payload occupies (incl.
    the DPSK reference point), int64."""
    dev = plen.device
    tab = on(_enc_len_table(fecs, enc_max), dev)
    crc_w = torch.tensor([0, 2, 4], dtype=torch.int64,
                         device=dev)[check.to(torch.int64)]
    n1 = torch.clamp(plen.to(torch.int64) + crc_w, 0, dec_max)
    n2 = tab[f0.to(torch.int64), n1]
    n3 = tab[f1.to(torch.int64), torch.clamp(n2, 0, enc_max)]
    m = mod.to(torch.int64)
    bps = on(_BPS, dev)[m]
    used = (n3 * 8 + bps - 1) // bps
    return used + on(_IS_DIFF, dev)[m].to(torch.int64)


def payload_evm_mse(points: torch.Tensor, mod, used) -> torch.Tensor:
    """Per-row payload MSE vs nearest constellation point over the ``used``
    points (after the DPSK reference point)."""
    x, off = _diff_effective(points, mod)
    table = on(_stacked_tables(), points.device)[mod.to(torch.int64)]
    _, dmin = _nearest_sym(x, table)
    idx = torch.arange(points.shape[-1], device=points.device)[None, :]
    mask = (idx >= off[:, None]) & (idx < (used + off)[:, None])
    tot = torch.where(mask, dmin, torch.zeros_like(dmin)).sum(-1)
    return tot / torch.clamp(used.to(torch.float32), min=1.0)


def frame_evm_db(hevm_db, pay_mse, used, hdr_syms: int = HEADER_SYMS):
    """Header EVM (dB) combined with the payload MSE, energy-weighted
    over symbols (the reference's framesyncstats EVM)."""
    hmse = 10.0 ** (hevm_db / 10.0)
    u = used.to(torch.float32)
    tot = (hmse * hdr_syms + pay_mse * u) / (hdr_syms + u)
    return 10.0 * torch.log10(torch.clamp(tot, min=1e-12))


def _fit_bytes(s: int, out_bytes: int, in_bytes: int) -> int:
    """The largest decoded size ``<= out_bytes`` whose code in scheme ``s``
    fits ``in_bytes`` (at least 1)."""
    n = out_bytes
    while fec_mod.encoded_length(s, n) > in_bytes and n > 1:
        n -= 1
    return n


def _decode_fit(s: int, bufs: torch.Tensor, out_bytes: int) -> torch.Tensor:
    """Decode max-size ``bufs [..., in]`` in scheme ``s`` -> ``[...,
    out_bytes]``: as many bytes as fit, zero-padded."""
    n = _fit_bytes(s, out_bytes, bufs.shape[-1])
    dec = fec_mod.fec_decode(s, bufs[..., :fec_mod.encoded_length(s, n)], n)
    if n < out_bytes:
        dec = torch.nn.functional.pad(dec, (0, out_bytes - n))
    return dec


def _is_heavy(s: int) -> bool:
    return fec_mod._is_conv(s) or s == fec_mod.FEC_RS8


def fec_decode_switch(scheme_idx, buf: torch.Tensor, out_bytes: int,
                      fecs=PAYLOAD_FECS) -> torch.Tensor:
    """Decode one max-size ``buf`` -> ``[out_bytes]`` in scheme
    ``fecs[scheme_idx]`` (JAX's ``lax.switch``, which clamps the index: a
    host read of the index picks the branch)."""
    idx = min(max(int(scheme_idx), 0), len(fecs) - 1)
    return _decode_fit(fecs[idx], buf, out_bytes)


def decode_payload(sync_enc_max: int, dec_max: int, max_payload: int,
                   points: torch.Tensor, mod, f0, f1, check, plen, hvalid,
                   fecs=PAYLOAD_FECS):
    """One frame's received payload points ``[n_pts]`` -> (payload
    ``[max_payload]`` uint8, payload_valid)."""
    dev = points.device

    def one(v, dt=torch.int32):
        return torch.as_tensor(v, dtype=dt, device=dev).reshape(1)

    pbits, _ = generic_demod_bits(points[None], one(mod), sync_enc_max * 8)
    enc_buf = scramble(pack_bits(pbits[0]), salt=2)
    mid = fec_decode_switch(f1, enc_buf, sync_enc_max, fecs)
    dec = fec_decode_switch(f0, mid, dec_max, fecs)
    pvalid = one(hvalid, torch.bool) & crc_check_dynamic(
        one(check), dec[None], one(plen))
    keep = torch.arange(max_payload, device=dev) < one(plen)
    payload = torch.where(keep, dec[:max_payload],
                          torch.zeros_like(dec[:max_payload]))
    return payload, pvalid[0]


def _fec_batch(scheme_ids: torch.Tensor, bufs: torch.Tensor, out_bytes: int,
               fecs, rows: torch.Tensor = None, llrs: torch.Tensor = None,
               llr_ok: torch.Tensor = None) -> torch.Tensor:
    """Batched FEC decode ``bufs [K, in]`` with per-row scheme indices.

    A block-code scheme decodes the whole batch once and a masked select
    picks each row's result, as JAX.  A convolutional or RS scheme decodes
    only the rows that carry it (one host read of the ids a stage), every
    such row, header-valid or not: JAX decodes every row with every scheme
    and picks by id, so each row's bytes equal JAX's; a scheme no row
    carries costs nothing.  ``rows`` (bool ``[K]``, default all) narrows
    that to the rows whose bytes are read (a receiver's detected
    candidates: the ids of an empty slot are noise, mostly clipped to the
    last scheme, RS8); the conv/RS bytes of the other rows are then zeros
    where JAX decodes them anyway.

    With ``llrs`` (float ``[K, >= in*8]``, descrambled channel LLRs of
    ``bufs``) the convolutional schemes decode soft.  ``llr_ok`` (bool
    ``[K]``) marks the rows whose ``llrs`` are a view of ``bufs``; the other
    rows decode their hard bits as ±1 pseudo-LLRs, which the soft Viterbi
    treats as a hard decode.  Block codes and RS decode hard."""
    dev = bufs.device
    out = torch.zeros((bufs.shape[0], out_bytes), dtype=torch.uint8,
                      device=dev)
    sel = None
    if any(_is_heavy(s) for s in fecs):
        ids = scheme_ids.to(torch.int64)
        if rows is not None:
            ids = torch.where(rows, ids, torch.full_like(ids, -1))
        sel = ids.cpu().numpy()
    for idx, s in enumerate(fecs):
        if _is_heavy(s):
            pick = np.nonzero(sel == idx)[0]
            if not len(pick):
                continue
            pick = torch.as_tensor(pick, device=dev)
            if llrs is None or not fec_mod._is_conv(s):
                out[pick] = _decode_fit(s, bufs[pick], out_bytes)
                continue
            from ..ops import conv as conv_mod
            n = _fit_bytes(s, out_bytes, bufs.shape[-1])
            need = fec_mod.encoded_length(s, n)
            L = llrs[pick, :need * 8]
            if llr_ok is not None:
                bits = unpack_bits(bufs[pick, :need]).to(torch.float32)
                L = torch.where(llr_ok[pick, None], L, 2.0 * bits - 1.0)
            out[pick, :n] = conv_mod.conv_decode_soft(s, L, n)
            continue
        out = torch.where((scheme_ids == idx)[:, None],
                          _decode_fit(s, bufs, out_bytes), out)
    return out


def decode_payload_batch(sync_enc_max: int, dec_max: int, max_payload: int,
                         points: torch.Tensor, mod, f0, f1, check, plen,
                         hvalid, fecs=PAYLOAD_FECS, rows=None):
    """Batched payload decode for K candidates: ``points [K, n_pts]``,
    per-row props -> (payload [K, max_payload] uint8, payload_valid [K]).
    ``rows`` (bool ``[K]``): decode the conv/RS schemes only there, as
    :func:`_fec_batch` says."""
    return _decode_payload_rows(sync_enc_max, dec_max, max_payload, points,
                                mod, f0, f1, check, plen, hvalid, fecs,
                                rows, soft=False)


def decode_payload_batch_soft(sync_enc_max: int, dec_max: int,
                              max_payload: int, points: torch.Tensor, mod,
                              f0, f1, check, plen, hvalid,
                              fecs=PAYLOAD_FECS, rows=None):
    """:func:`decode_payload_batch` with soft LLRs into the convolutional
    branches: the points are demapped once to LLRs
    (:func:`generic_demod_soft`), whose signs give the hard bytes for the
    block codes and RS, and whose descrambled values (sign flipped where
    the scramble PN bit is 1) drive the soft Viterbi.  The outer stage
    (``fec1``) sees the channel LLRs; the inner (``fec0``) sees them only
    where ``fec1`` is none, since after a real outer decode they no longer
    describe its input, and decodes the other rows from ``fec1``'s hard
    output.  The same host reads as the hard path: the table-size gate and
    the scheme ids of each FEC stage."""
    return _decode_payload_rows(sync_enc_max, dec_max, max_payload, points,
                                mod, f0, f1, check, plen, hvalid, fecs,
                                rows, soft=True)


def _decode_payload_rows(sync_enc_max, dec_max, max_payload, points, mod,
                         f0, f1, check, plen, hvalid, fecs, rows,
                         soft: bool):
    bps_all = on(_BPS, points.device)[mod.to(torch.int64)]
    # host-side table-size gate (a device sync): 64 entries cover every
    # scheme with bps <= 6; entries past 2^bps are padding and never win
    n_tab = 64 if bool((bps_all <= 6).all()) else _MAX_CONST
    llr_desc = llr_ok = None
    if soft:
        llrs = generic_demod_soft(points, mod, sync_enc_max * 8, n_tab)
        pbits = (llrs > 0).to(torch.uint8)
        llr_desc = llrs * on(_pn_signs(sync_enc_max, 2), points.device)
        llr_ok = f1 == fec_mod.FEC_NONE
    else:
        pbits, _ = generic_demod_bits(points, mod, sync_enc_max * 8, n_tab)
    enc = scramble(pack_bits(pbits), salt=2)
    mid = _fec_batch(f1, enc, sync_enc_max, fecs, rows=rows, llrs=llr_desc)
    dec = _fec_batch(f0, mid, dec_max, fecs, rows=rows, llrs=llr_desc,
                     llr_ok=llr_ok)
    pvalid = hvalid & crc_check_dynamic(check, dec, plen)
    keep = torch.arange(max_payload, device=points.device)[None, :] < \
        plen[:, None]
    payload = torch.where(keep, dec[:, :max_payload],
                          torch.zeros_like(dec[:, :max_payload]))
    return payload, pvalid
