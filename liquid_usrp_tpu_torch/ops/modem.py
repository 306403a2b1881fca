"""Linear modem: constellation map/demap for the PSK/DPSK/ASK/QAM/APSK
families (all 50 scheme ids).

Port of ``liquid_usrp_tpu/ops/modem.py``.  The constellation tables are
generated host-side in NumPy float64 by the JAX package's builders, copied
here verbatim (the tests compare every table), and normalized to unit
average energy.  Modulation is a table gather; hard demodulation is a
nearest-point argmin over a ``[..., 2^bps]`` distance matrix, soft
demodulation a max-log per-bit minimum over the same matrix.  Differential
PSK keeps its phase reference between blocks (``dpsk_modulate`` /
``dpsk_demodulate``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.consts import on
from ..utils.device import default_device

__all__ = [
    "mod_names", "mod_from_name", "mod_name", "bits_per_symbol",
    "is_differential", "constellation", "modulate", "demodulate",
    "demodulate_soft", "bits_to_symbols", "symbols_to_bits", "evm",
    "dpsk_modulate", "dpsk_demodulate",
]

# scheme ids 0-16 are the original compact set; 17+ extend to the full
# liquid string-parser surface (PSK/DPSK/ASK/QAM/APSK power-of-two
# ladders + ook/V29).  Ids are wire format (the frame header's mod
# field) — append only, never renumber.
MOD_BPSK = 0
MOD_QPSK = 1
MOD_PSK8 = 2
MOD_PSK16 = 3
MOD_DPSK2 = 4
MOD_DPSK4 = 5
MOD_DPSK8 = 6
MOD_ASK2 = 7
MOD_ASK4 = 8
MOD_ASK8 = 9
MOD_QAM16 = 10
MOD_QAM32 = 11
MOD_QAM64 = 12
MOD_QAM128 = 13
MOD_QAM256 = 14
MOD_APSK16 = 15
MOD_APSK32 = 16
MOD_PSK2 = 17
MOD_PSK4 = 18
MOD_PSK32 = 19
MOD_PSK64 = 20
MOD_PSK128 = 21
MOD_PSK256 = 22
MOD_DPSK16 = 23
MOD_DPSK32 = 24
MOD_DPSK64 = 25
MOD_DPSK128 = 26
MOD_DPSK256 = 27
MOD_ASK16 = 28
MOD_ASK32 = 29
MOD_ASK64 = 30
MOD_ASK128 = 31
MOD_ASK256 = 32
MOD_QAM4 = 33
MOD_QAM8 = 34
MOD_APSK4 = 35
MOD_APSK8 = 36
MOD_APSK64 = 37
MOD_APSK128 = 38
MOD_APSK256 = 39
MOD_OOK = 40
MOD_V29 = 41
# ids 42+: the remaining liquid string-parser surface:
# quadrant-replicated 'square' cross-QAM and optimal-packing /
# arbitrary-demo constellations
MOD_SQAM32 = 42
MOD_SQAM128 = 43
MOD_ARB16OPT = 44
MOD_ARB32OPT = 45
MOD_ARB64OPT = 46
MOD_ARB128OPT = 47
MOD_ARB256OPT = 48
MOD_ARB64VT = 49

_NAMES = {
    MOD_BPSK: "bpsk", MOD_QPSK: "qpsk", MOD_PSK8: "psk8", MOD_PSK16: "psk16",
    MOD_DPSK2: "dpsk2", MOD_DPSK4: "dpsk4", MOD_DPSK8: "dpsk8",
    MOD_ASK2: "ask2", MOD_ASK4: "ask4", MOD_ASK8: "ask8",
    MOD_QAM16: "qam16", MOD_QAM32: "qam32", MOD_QAM64: "qam64",
    MOD_QAM128: "qam128", MOD_QAM256: "qam256",
    MOD_APSK16: "apsk16", MOD_APSK32: "apsk32",
    MOD_PSK2: "psk2", MOD_PSK4: "psk4", MOD_PSK32: "psk32",
    MOD_PSK64: "psk64", MOD_PSK128: "psk128", MOD_PSK256: "psk256",
    MOD_DPSK16: "dpsk16", MOD_DPSK32: "dpsk32", MOD_DPSK64: "dpsk64",
    MOD_DPSK128: "dpsk128", MOD_DPSK256: "dpsk256",
    MOD_ASK16: "ask16", MOD_ASK32: "ask32", MOD_ASK64: "ask64",
    MOD_ASK128: "ask128", MOD_ASK256: "ask256",
    MOD_QAM4: "qam4", MOD_QAM8: "qam8",
    MOD_APSK4: "apsk4", MOD_APSK8: "apsk8", MOD_APSK64: "apsk64",
    MOD_APSK128: "apsk128", MOD_APSK256: "apsk256",
    MOD_OOK: "ook", MOD_V29: "v29",
    MOD_SQAM32: "sqam32", MOD_SQAM128: "sqam128",
    MOD_ARB16OPT: "arb16opt", MOD_ARB32OPT: "arb32opt",
    MOD_ARB64OPT: "arb64opt", MOD_ARB128OPT: "arb128opt",
    MOD_ARB256OPT: "arb256opt", MOD_ARB64VT: "arb64vt",
}
_BY_NAME = {v: k for k, v in _NAMES.items()}

_BPS = {
    MOD_BPSK: 1, MOD_QPSK: 2, MOD_PSK8: 3, MOD_PSK16: 4,
    MOD_DPSK2: 1, MOD_DPSK4: 2, MOD_DPSK8: 3,
    MOD_ASK2: 1, MOD_ASK4: 2, MOD_ASK8: 3,
    MOD_QAM16: 4, MOD_QAM32: 5, MOD_QAM64: 6, MOD_QAM128: 7, MOD_QAM256: 8,
    MOD_APSK16: 4, MOD_APSK32: 5,
    MOD_PSK2: 1, MOD_PSK4: 2, MOD_PSK32: 5, MOD_PSK64: 6, MOD_PSK128: 7,
    MOD_PSK256: 8,
    MOD_DPSK16: 4, MOD_DPSK32: 5, MOD_DPSK64: 6, MOD_DPSK128: 7,
    MOD_DPSK256: 8,
    MOD_ASK16: 4, MOD_ASK32: 5, MOD_ASK64: 6, MOD_ASK128: 7, MOD_ASK256: 8,
    MOD_QAM4: 2, MOD_QAM8: 3,
    MOD_APSK4: 2, MOD_APSK8: 3, MOD_APSK64: 6, MOD_APSK128: 7,
    MOD_APSK256: 8,
    MOD_OOK: 1, MOD_V29: 4,
    MOD_SQAM32: 5, MOD_SQAM128: 7,
    MOD_ARB16OPT: 4, MOD_ARB32OPT: 5, MOD_ARB64OPT: 6, MOD_ARB128OPT: 7,
    MOD_ARB256OPT: 8, MOD_ARB64VT: 6,
}


def mod_names():
    return list(_NAMES.values())


def mod_from_name(name: str) -> int:
    try:
        return _BY_NAME[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown modulation '{name}'; supported: {mod_names()}")


def mod_name(scheme: int) -> str:
    return _NAMES[scheme]


def bits_per_symbol(scheme: int) -> int:
    return _BPS[scheme]


def _gray(n: int) -> int:
    return n ^ (n >> 1)


def _inv_gray_perm(bps: int) -> np.ndarray:
    """perm[sym] = constellation index such that table[sym] is gray-ordered."""
    perm = np.zeros(1 << bps, dtype=np.int64)
    for i in range(1 << bps):
        perm[_gray(i)] = i
    return perm


def _psk(bps: int, offset: float | None = None) -> np.ndarray:
    M = 1 << bps
    idx = _inv_gray_perm(bps)  # symbol -> angular position (gray coded)
    if offset is None:
        offset = np.pi / 4 if bps == 2 else 0.0
    ang = 2 * np.pi * idx / M + offset
    return np.exp(1j * ang)


def _ask(bps: int) -> np.ndarray:
    M = 1 << bps
    idx = _inv_gray_perm(bps)
    levels = 2 * idx - (M - 1)
    c = levels.astype(np.complex128)
    return c / np.sqrt(np.mean(np.abs(c) ** 2))


def _qam(bps: int) -> np.ndarray:
    """Gray-coded QAM; square for even bps, cross-ish (rect) for odd."""
    bi = (bps + 1) // 2
    bq = bps - bi
    Mi, Mq = 1 << bi, 1 << bq
    pi = _inv_gray_perm(bi)
    pq = _inv_gray_perm(bq)
    pts = np.zeros(1 << bps, dtype=np.complex128)
    for s in range(1 << bps):
        si, sq = s >> bq, s & (Mq - 1)
        re = 2 * pi[si] - (Mi - 1)
        im = 2 * pq[sq] - (Mq - 1)
        pts[s] = re + 1j * im
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def _apsk(rings: list[tuple[int, float, float]], bps: int) -> np.ndarray:
    """Amplitude-phase shift keying from (points, radius, phase0) rings."""
    pts = []
    for npts, rad, ph0 in rings:
        ang = 2 * np.pi * np.arange(npts) / npts + ph0
        pts.append(rad * np.exp(1j * ang))
    c = np.concatenate(pts)
    assert c.shape[0] == 1 << bps
    c = c / np.sqrt(np.mean(np.abs(c) ** 2))
    # gray-ish mapping: table[sym] = c[angular position], same convention
    # as _psk (the inverted .argsort() form put 2-bit flips between
    # several angularly adjacent points)
    return c[_inv_gray_perm(bps)]


def _sqam(bps: int) -> np.ndarray:
    """Quadrant-replicated 'square' cross-QAM (liquid's sqam32/sqam128
    family shape): one quarter-plane point set mirrored into all four
    quadrants, with the two MSBs gray-selecting the quadrant.

    * sqam32:  quarter = 3x3 odd grid minus the outer corner (8 points)
      -> the standard 6x6-minus-corners cross-32 constellation.
    * sqam128: quarter = 6x6 odd grid minus the 2x2 outer corner
      (32 points) -> 12x12-minus-2x2-corners cross-128.
    """
    if bps == 5:
        side, cut = 3, 1
    elif bps == 7:
        side, cut = 6, 2
    else:
        raise ValueError(f"sqam supports bps in (5, 7), got {bps}")
    quarter = []
    for iy in range(side):
        for ix in range(side):
            if ix >= side - cut and iy >= side - cut:
                continue                       # clip the outer corner
            quarter.append((2 * ix + 1) + 1j * (2 * iy + 1))
    quarter = np.array(quarter, dtype=np.complex128)
    assert quarter.shape[0] == 1 << (bps - 2)
    # quadrant bits are gray coded: 00 -> (+,+), 01 -> (-,+),
    # 11 -> (-,-), 10 -> (+,-): adjacent quadrants differ in one bit
    signs = {0: (1, 1), 1: (-1, 1), 3: (-1, -1), 2: (1, -1)}
    pts = np.zeros(1 << bps, dtype=np.complex128)
    nq = 1 << (bps - 2)
    for q, (sx, sy) in signs.items():
        pts[q * nq:(q + 1) * nq] = sx * quarter.real + 1j * sy * quarter.imag
    # the mapping above keeps conjugate/mirror symmetry: quadrant bit
    # flips mirror the point, so quadrant-boundary neighbors stay close
    # in Hamming distance
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def _arb_opt(M: int) -> np.ndarray:
    """Near-optimal-packing M-point constellation (liquid's arb*opt
    capability): the M lowest-energy points of the hexagonal lattice —
    the optimal 2-D packing — recentered and unit-energy normalized.
    Deterministic (stable sorts over a fixed lattice enumeration)."""
    R = int(np.ceil(np.sqrt(M))) + 3
    w = np.exp(1j * np.pi / 3)
    pts = np.array([i + j * w
                    for i in range(-R, R + 1)
                    for j in range(-R, R + 1)])
    sel = pts[np.argsort(np.abs(pts), kind="stable")[:M]]
    for _ in range(3):       # recenter shifts the energy ranking slightly
        c = sel.mean()
        sel = pts[np.argsort(np.abs(pts - c), kind="stable")[:M]]
    sel = sel - sel.mean()
    return sel / np.sqrt(np.mean(np.abs(sel) ** 2))


def _arb64vt() -> np.ndarray:
    """64-point arbitrary demonstration constellation (the reference's
    parser accepts liquid's 'arb64vt' demo table; this framework's
    stand-in is a golden-angle sunflower spiral — evenly spread,
    distinct radii/phases, good minimum distance)."""
    k = np.arange(64)
    r = np.sqrt(k + 0.5)
    th = k * np.pi * (3.0 - np.sqrt(5.0))      # golden angle
    c = r * np.exp(1j * th)
    c = c - c.mean()
    return c / np.sqrt(np.mean(np.abs(c) ** 2))


def _v29() -> np.ndarray:
    """ITU-T V.29 16-point constellation (public standard): axis points at
    amplitudes 3 and 5, diagonal points at (+-1,+-1) and (+-3,+-3)."""
    pts = []
    for a in (3.0, 5.0):
        pts += [a, -a, 1j * a, -1j * a]
    for a in (1.0, 3.0):
        pts += [a + 1j * a, -a + 1j * a, -a - 1j * a, a - 1j * a]
    c = np.array(pts, dtype=np.complex128)
    return c / np.sqrt(np.mean(np.abs(c) ** 2))


# APSK ring layouts (points per ring); radii rise linearly and the whole
# constellation is unit-energy normalized.  Ring structure matches the
# liquid scheme family surface (apsk4..apsk256).
_APSK_RINGS = {
    MOD_APSK4: (1, 3),
    MOD_APSK8: (1, 7),
    # APSK16/32 are NOT here: _table_np hands them hard-coded ring specs
    # (radius/phase tuned) before reaching this generic table.
    MOD_APSK64: (4, 14, 20, 26),
    MOD_APSK128: (8, 18, 24, 36, 42),
    MOD_APSK256: (6, 18, 32, 36, 46, 54, 64),
}


def _apsk_scheme(scheme: int, bps: int) -> np.ndarray:
    rings = _APSK_RINGS[scheme]
    spec = []
    for i, npts in enumerate(rings):
        rad = 0.0 if npts == 1 else (i + 1.0)
        ph0 = np.pi / npts if i % 2 == 0 and npts > 1 else 0.0
        spec.append((npts, rad, ph0))
    return _apsk(spec, bps)


@functools.lru_cache(maxsize=None)
def _table_np(scheme: int) -> np.ndarray:
    if scheme in (MOD_BPSK, MOD_DPSK2, MOD_PSK2):
        return np.array([1.0 + 0j, -1.0 + 0j])
    if scheme in (MOD_QPSK, MOD_DPSK4):
        return _psk(2)
    if scheme == MOD_PSK4:
        return _psk(2, offset=0.0)
    if scheme in (MOD_PSK8, MOD_DPSK8):
        return _psk(3)
    if scheme in (MOD_PSK16, MOD_DPSK16):
        return _psk(4)
    if scheme in (MOD_PSK32, MOD_DPSK32):
        return _psk(5)
    if scheme in (MOD_PSK64, MOD_DPSK64):
        return _psk(6)
    if scheme in (MOD_PSK128, MOD_DPSK128):
        return _psk(7)
    if scheme in (MOD_PSK256, MOD_DPSK256):
        return _psk(8)
    if scheme == MOD_OOK:
        return np.array([np.sqrt(2.0) + 0j, 0.0 + 0j])
    if scheme == MOD_V29:
        return _v29()
    ask_bps = {MOD_ASK2: 1, MOD_ASK4: 2, MOD_ASK8: 3, MOD_ASK16: 4,
               MOD_ASK32: 5, MOD_ASK64: 6, MOD_ASK128: 7, MOD_ASK256: 8}
    if scheme in ask_bps:
        return _ask(ask_bps[scheme])
    qam_bps = {MOD_QAM4: 2, MOD_QAM8: 3, MOD_QAM16: 4, MOD_QAM32: 5,
               MOD_QAM64: 6, MOD_QAM128: 7, MOD_QAM256: 8}
    if scheme in qam_bps:
        return _qam(qam_bps[scheme])
    if scheme == MOD_APSK16:
        return _apsk([(4, 0.5, np.pi / 4), (12, 1.2, 0.0)], 4)
    if scheme == MOD_APSK32:
        return _apsk([(4, 0.35, np.pi / 4), (12, 0.85, 0.0),
                      (16, 1.3, np.pi / 16)], 5)
    if scheme in _APSK_RINGS:
        return _apsk_scheme(scheme, _BPS[scheme])
    if scheme in (MOD_SQAM32, MOD_SQAM128):
        return _sqam(_BPS[scheme])
    if scheme in (MOD_ARB16OPT, MOD_ARB32OPT, MOD_ARB64OPT,
                  MOD_ARB128OPT, MOD_ARB256OPT):
        return _arb_opt(1 << _BPS[scheme])
    if scheme == MOD_ARB64VT:
        return _arb64vt()
    raise ValueError(f"unknown modulation scheme {scheme}")


def is_differential(scheme: int) -> bool:
    return scheme in (MOD_DPSK2, MOD_DPSK4, MOD_DPSK8, MOD_DPSK16,
                      MOD_DPSK32, MOD_DPSK64, MOD_DPSK128, MOD_DPSK256)


@functools.lru_cache(maxsize=None)
def _table_c64(scheme: int) -> np.ndarray:
    return _table_np(scheme).astype(np.complex64)


def constellation(scheme: int, device=None) -> torch.Tensor:
    """Unit-energy constellation table ``[2^bps]`` complex64 on ``device``
    (``None``: the card, ``utils/device.py``)."""
    return on(_table_c64(scheme), default_device(device))


def modulate(scheme: int, symbols: torch.Tensor) -> torch.Tensor:
    """Map symbol indices ``[...]`` (ints < 2^bps) to complex64 points.

    Differential schemes map the *phase increment*; the cumulative
    rotation is applied by the caller (``payload.diff_encode_points``).
    """
    return constellation(scheme, symbols.device)[symbols.to(torch.int64)]


def demodulate(scheme: int, x: torch.Tensor) -> torch.Tensor:
    """Nearest-point hard demap: complex ``[...]`` -> int32 symbol indices
    (first minimum on ties, as ``jnp.argmin``)."""
    table = constellation(scheme, x.device)
    d2 = torch.abs(x[..., None] - table) ** 2
    return torch.argmin(d2, dim=-1).to(torch.int32)


def demodulate_soft(scheme: int, x: torch.Tensor,
                    noise_var: float = 0.1) -> torch.Tensor:
    """Max-log per-bit metrics ``[..., bps]``, MSB first (positive => bit 1
    likelier): ``(min_{c: bit_b(c)=0} d2 - min_{c: bit_b(c)=1} d2) /
    noise_var``, so a hard decision is ``metric > 0``.  Distances are
    ``(xr-tr)**2 + (xi-ti)**2`` in float32, as the hard demappers of
    ``framing/payload.py`` compute them."""
    table = constellation(scheme, x.device)
    bps = _BPS[scheme]
    d2 = (x.real[..., None] - table.real) ** 2 + \
        (x.imag[..., None] - table.imag) ** 2
    idx = torch.arange(table.shape[0], device=x.device)
    inf = torch.tensor(float("inf"), device=x.device)
    llrs = []
    for b in range(bps - 1, -1, -1):
        bit = ((idx >> b) & 1).bool()
        d0 = torch.where(bit, inf, d2).amin(-1)
        d1 = torch.where(bit, d2, inf).amin(-1)
        llrs.append((d0 - d1) / noise_var)
    return torch.stack(llrs, dim=-1)


def bits_to_symbols(bits: torch.Tensor, bps: int) -> torch.Tensor:
    """Bit stream ``[..., n_sym*bps]`` (MSB-first) -> int32 symbols."""
    n_sym = bits.shape[-1] // bps
    b = bits.reshape(*bits.shape[:-1], n_sym, bps).to(torch.int32)
    weights = torch.tensor([1 << (bps - 1 - i) for i in range(bps)],
                           dtype=torch.int32, device=bits.device)
    return (b * weights).sum(-1).to(torch.int32)


def symbols_to_bits(symbols: torch.Tensor, bps: int) -> torch.Tensor:
    """int symbols ``[..., n_sym]`` -> bit stream ``[..., n_sym*bps]``."""
    shifts = torch.arange(bps - 1, -1, -1, dtype=torch.int32,
                          device=symbols.device)
    bits = (symbols[..., None].to(torch.int32) >> shifts) & 1
    return bits.reshape(*symbols.shape[:-1],
                        symbols.shape[-1] * bps).to(torch.uint8)


def evm(scheme: int, x: torch.Tensor, symbols: torch.Tensor) -> torch.Tensor:
    """Error-vector magnitude (dB) of received points vs ideal symbols."""
    ideal = modulate(scheme, symbols)
    mse = torch.mean(torch.abs(x - ideal) ** 2, dim=-1)
    return 10.0 * torch.log10(torch.clamp(mse, min=1e-12))


# ---------------------------------------------------------------------------
# differential PSK (stateful: phase reference carried between blocks)
# ---------------------------------------------------------------------------

def _dpsk_ref(scheme: int, ref, like: torch.Tensor) -> torch.Tensor:
    if not is_differential(scheme):
        raise ValueError(f"{mod_name(scheme)} is not a differential scheme")
    if ref is None:
        return torch.ones((), dtype=torch.complex64, device=like.device)
    return torch.as_tensor(ref, dtype=torch.complex64, device=like.device)


def dpsk_modulate(scheme: int, symbols: torch.Tensor, ref=None):
    """Differential modulate: symbol k selects a phase *increment*.

    ``ref`` is the previous transmitted point (complex scalar; 1+0j at a
    burst start).  Returns ``(points, new_ref)``.  The rotation is a complex
    ``cumprod``, which rounds in its own order on each backend: points agree
    with the JAX package's within 5e-5 over 2,048 symbols (the tests'
    tolerance; measured 2.0e-5)."""
    ref = _dpsk_ref(scheme, ref, symbols)
    points = ref * torch.cumprod(modulate(scheme, symbols), dim=0)
    return points, points[-1]


def dpsk_demodulate(scheme: int, x: torch.Tensor, ref=None):
    """Differential demodulate: decisions on ``x[k] * conj(x[k-1])``
    (constant phase offsets and slow CFO cancel).  Returns ``(symbols,
    new_ref)``."""
    ref = _dpsk_ref(scheme, ref, x)
    prev = torch.cat([ref.reshape(1), x[:-1]])
    d = x * torch.conj(prev)
    return demodulate(scheme, d / torch.clamp(torch.abs(d), min=1e-12)), \
        x[-1]
