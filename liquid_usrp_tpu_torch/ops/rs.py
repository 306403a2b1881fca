"""Reed-Solomon RS(255,223) over GF(256) — batched codec.

Port of ``liquid_usrp_tpu/ops/rs.py`` (``rs8``): the field generated by
``x^8+x^4+x^3+x^2+1`` (0x11D), first consecutive root alpha^1, t = 16 byte
errors per block.  The host side (GF(256) tables, generator polynomial,
the Chien/Forney position tables, block layout and the NumPy oracle) is
copied verbatim; the binary parity and syndrome matrices are built in
closed form, equal to JAX's probed ones.

* Encode and syndromes are GF(2)-linear: one ``gf2_matmul`` each against
  the precomputed binary matrices.
* Berlekamp-Massey runs its fixed 32 iterations as a Python loop with
  masked updates, batched over every block of every row.
* Chien search and Forney evaluate the locator and evaluator at every
  codeword position at once through the inverse-power tables.

JAX reduces GF(256) sums with ``lax.reduce(bitwise_xor)``; torch has no
XOR reduction, so the port reduces bit planes: the XOR of bytes is the
parity of each bit position's sum, exact.  GF(256) products gather
``antilog[log a + log b]`` with the sum clamped into the 510-entry table
(``log[0]`` is a placeholder that the zero mask overrides).

Shortening: messages are chopped into <=223-byte blocks; a short block is
zero-padded (the zero bytes are stripped on the wire and re-inserted,
position-consistently, before decoding).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.bits import gf2_matmul, pack_bits, unpack_bits
from ..utils.consts import on

__all__ = ["RS_N", "RS_K", "rs_encoded_length", "rs_encode", "rs_decode",
           "np_rs_roundtrip_check"]

RS_N = 255
RS_K = 223
_T = 16                          # correctable byte errors per block
_NPAR = 2 * _T                   # 32 parity bytes
_PRIM = 0x11D
_FCR = 1                         # first consecutive root exponent


# ---------------------------------------------------------------------------
# host-side GF(256) arithmetic + table construction
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gf_tables():
    antilog = np.zeros(510, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        antilog[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _PRIM
    antilog[255:] = antilog[:255]
    return log, antilog


def _mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    log, antilog = _gf_tables()
    return int(antilog[log[a] + log[b]])


def _pow(a: int, n: int) -> int:
    if a == 0:
        return 0
    log, antilog = _gf_tables()
    return int(antilog[(log[a] * (n % 255)) % 255])


def _inv(a: int) -> int:
    log, antilog = _gf_tables()
    return int(antilog[(255 - log[a]) % 255])


@functools.lru_cache(maxsize=None)
def _gen_poly() -> np.ndarray:
    """g(x) = prod_{j=0}^{2t-1} (x - alpha^(FCR+j)), low-degree first."""
    g = np.array([1], dtype=np.int64)
    for j in range(_NPAR):
        r = _pow(2, _FCR + j)
        ng = np.zeros(len(g) + 1, dtype=np.int64)
        for i, c in enumerate(g):
            ng[i] ^= _mul(int(c), r)     # * (-r) == * r in GF(2^m)
            ng[i + 1] ^= int(c)          # * x
        g = ng
    assert g[-1] == 1
    return g


def _np_parity(msg: np.ndarray) -> np.ndarray:
    """Systematic parity of a K-byte message (polynomial long division).

    Codeword = [msg | parity]; msg[0] is the x^(N-1) coefficient, parity
    occupies degrees NPAR-1..0 (parity[0] = degree NPAR-1 coefficient).
    """
    g = _gen_poly()
    rem = np.zeros(_NPAR, dtype=np.int64)  # rem[k] = coeff of x^(NPAR-1-k)
    for m in msg:
        fb = int(m) ^ int(rem[0])
        rem[:-1] = rem[1:]
        rem[-1] = 0
        if fb:
            for k in range(_NPAR):
                # subtract fb * g(x) * x^(appropriate); g coeff for
                # degree NPAR-1-k is g[NPAR-1-k]
                rem[k] ^= _mul(fb, int(g[_NPAR - 1 - k]))
    return rem.astype(np.uint8)


def _np_syndromes(code: np.ndarray) -> np.ndarray:
    """S_j = c(alpha^(FCR+j)), c(x) = sum_i code[i] x^(N-1-i)."""
    out = np.zeros(_NPAR, dtype=np.int64)
    for j in range(_NPAR):
        a = _pow(2, _FCR + j)
        acc = 0
        for c in code:
            acc = _mul(acc, a) ^ int(c)  # Horner
        out[j] = acc
    return out.astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _codec_matrices():
    """Binary parity matrix P [K*8, NPAR*8] and syndrome matrix
    S [N*8, NPAR*8]: row ``byte*8 + bit`` is the map of the unit input
    ``v = 1 << (7 - bit)`` at ``byte``.

    The JAX package probes :func:`_np_parity` and :func:`_np_syndromes`
    with each unit input (18 s of Python); the port evaluates the same maps
    in closed form, equal entry for entry (the tests compare the matrices):
    the parity of ``v x^e`` (``e = N-1-byte``) is ``v (x^e mod g)`` and its
    syndromes are ``S_j = v alpha^((FCR+j) e)``."""
    g = _gen_poly()
    # x^e mod g(x), low-degree first, for e = 0 .. N-1
    xpow = np.zeros((RS_N, _NPAR), dtype=np.int64)
    r = np.zeros(_NPAR, dtype=np.int64)
    r[0] = 1
    for e in range(RS_N):
        xpow[e] = r
        top = int(r[-1])
        r = np.concatenate([[0], r[:-1]])
        if top:               # x^NPAR = sum_i g_i x^i (characteristic 2)
            r ^= np.array([_mul(top, int(c)) for c in g[:_NPAR]])
    P = np.zeros((RS_K * 8, _NPAR * 8), dtype=np.uint8)
    for byte in range(RS_K):
        rem = xpow[RS_N - 1 - byte][::-1]   # rem[k] = coeff of x^(NPAR-1-k)
        for bit in range(8):
            v = 1 << (7 - bit)
            P[byte * 8 + bit] = np.unpackbits(np.array(
                [_mul(v, int(c)) for c in rem], dtype=np.uint8))
    S = np.zeros((RS_N * 8, _NPAR * 8), dtype=np.uint8)
    for byte in range(RS_N):
        e = RS_N - 1 - byte
        roots = [_pow(2, (_FCR + j) * e) for j in range(_NPAR)]
        for bit in range(8):
            v = 1 << (7 - bit)
            S[byte * 8 + bit] = np.unpackbits(np.array(
                [_mul(v, a) for a in roots], dtype=np.uint8))
    return P, S


@functools.lru_cache(maxsize=None)
def _position_tables():
    """Per-position inverse-power tables for Chien/Forney.

    Position ``i`` on the wire is the degree-(N-1-i) coefficient, so its
    locator root is ``X_i = alpha^(N-1-i)``.  Tables (length N):
      * ``lam_pows[i, k]  = X_i^-k``            (k = 0..T,  Lambda eval)
      * ``om_pows[i, j]   = X_i^-j``            (j = 0..2t-1, Omega eval)
      * ``dlam_pows[i, k] = X_i^-(k-1)`` for odd k else 0 (Lambda' eval)
      * ``xfac[i]         = X_i^(1-FCR)``       (Forney factor)
    """
    lam = np.zeros((RS_N, _T + 1), dtype=np.int32)
    om = np.zeros((RS_N, _NPAR), dtype=np.int32)
    dlam = np.zeros((RS_N, _T + 1), dtype=np.int32)
    xfac = np.zeros(RS_N, dtype=np.int32)
    for i in range(RS_N):
        X = _pow(2, RS_N - 1 - i)
        Xi = _inv(X)
        for k in range(_T + 1):
            lam[i, k] = _pow(Xi, k)
            if k % 2 == 1:
                dlam[i, k] = _pow(Xi, k - 1)
        for j in range(_NPAR):
            om[i, j] = _pow(Xi, j)
        xfac[i] = _pow(X, 1 - _FCR)
    return lam, om, dlam, xfac


@functools.lru_cache(maxsize=None)
def _bm_tables():
    """Static index tables of the decoder: per Berlekamp-Massey iteration
    ``n`` the syndrome index ``n - i`` of ``C[i]`` (``i = 1..T``, clamped)
    and its validity; for Omega the syndrome index ``n - i`` per (power
    ``n``, locator power ``i``) and its validity."""
    i = np.arange(1, _T + 1)
    sidx = np.arange(_NPAR)[:, None] - i[None, :]                # [2t, T]
    j = np.arange(_NPAR)[:, None] - np.arange(_T + 1)[None, :]   # [2t, T+1]
    return (np.clip(sidx, 0, _NPAR - 1).astype(np.int64), sidx >= 0,
            np.clip(j, 0, _NPAR - 1).astype(np.int64),
            (j >= 0) & (j < _NPAR))


# ---------------------------------------------------------------------------
# block layout / shortening
# ---------------------------------------------------------------------------

def _block_layout(n_bytes: int):
    """(nblocks, data_lens): data bytes per block (last may be short)."""
    nblocks = max(1, -(-n_bytes // RS_K))
    lens = [RS_K] * nblocks
    lens[-1] = n_bytes - RS_K * (nblocks - 1)
    return nblocks, lens


def rs_encoded_length(n_bytes: int) -> int:
    nblocks, _ = _block_layout(n_bytes)
    return n_bytes + nblocks * _NPAR


def rs_encode(data: torch.Tensor) -> torch.Tensor:
    """Encode uint8 ``[..., n]`` -> ``[..., n + 32 * nblocks]``
    (systematic, shortened last block)."""
    P, _ = _codec_matrices()
    n = int(data.shape[-1])
    lead = data.shape[:-1]
    nblocks, lens = _block_layout(n)
    padded = torch.nn.functional.pad(
        data.to(torch.uint8), (0, nblocks * RS_K - n)).reshape(
            *lead, nblocks, RS_K)
    parity = pack_bits(gf2_matmul(unpack_bits(padded),
                                  on(P, data.device)))    # [..., nb, 2t]
    pieces = []
    for b in range(nblocks):
        pieces.append(padded[..., b, :lens[b]])
        pieces.append(parity[..., b, :])
    return torch.cat(pieces, dim=-1)


_SHIFTS8 = np.arange(8, dtype=np.int64)


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of the bytes ``x`` (int64 in [0, 256)) along ``dim``: the parity
    of each bit plane's sum."""
    shifts = on(_SHIFTS8, x.device)
    planes = (x.unsqueeze(-1) >> shifts) & 1
    par = planes.sum(dim - 1 if dim < 0 else dim) & 1
    return (par << shifts).sum(-1)


def _gfv(log_t, antilog_t, a, b):
    """Elementwise GF(256) multiply of bytes ``a``, ``b`` (int64) via
    table gathers."""
    s = torch.clamp(log_t[a] + log_t[b], 0, antilog_t.shape[0] - 1)
    prod = antilog_t[s]
    return torch.where((a == 0) | (b == 0), torch.zeros_like(prod), prod)


def _ginv(log_t, antilog_t, a):
    """GF(256) inverse of the nonzero bytes ``a`` (int64)."""
    return antilog_t[(255 - log_t[a]) % 255]


def rs_decode(coded: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """Decode ``[..., n_coded]`` -> uint8 ``[..., n_bytes]`` (corrects <=16
    byte errors per block)."""
    _, S = _codec_matrices()
    lam_np, om_np, dlam_np, xfac_np = _position_tables()
    log_np, antilog_np = _gf_tables()
    sidx_np, svalid_np, oidx_np, ovalid_np = _bm_tables()
    dev = coded.device
    log_t = on(log_np, dev, torch.int64)
    antilog_t = on(antilog_np, dev, torch.int64)
    lead = coded.shape[:-1]
    flat = coded.reshape(-1, coded.shape[-1]).to(torch.uint8)

    nblocks, lens = _block_layout(n_bytes)
    # rebuild full N-byte codewords (virtual zeros where the encoder padded
    # the end of a short block's data region)
    rows = []
    off = 0
    for b in range(nblocks):
        d = lens[b]
        rows.append(torch.cat([
            flat[:, off:off + d],
            torch.zeros((flat.shape[0], RS_K - d), dtype=torch.uint8,
                        device=dev),
            flat[:, off + d:off + d + _NPAR]], dim=-1))
        off += d + _NPAR
    blocks8 = torch.stack(rows, dim=1).reshape(-1, RS_N)   # [B, N]
    blocks = blocks8.to(torch.int64)
    B = blocks.shape[0]

    # syndromes: one GF(2) matmul
    synd = pack_bits(gf2_matmul(unpack_bits(blocks8), on(S, dev))).to(
        torch.int64)                                       # [B, 2t]

    # --- Berlekamp-Massey (fixed 2t iterations, masked updates) ---
    sidx, svalid = on(sidx_np, dev), on(svalid_np, dev)
    kidx = torch.arange(_T + 1, device=dev)
    C = torch.zeros((B, _T + 1), dtype=torch.int64, device=dev)
    C[:, 0] = 1
    Bb = C.clone()
    L = torch.zeros(B, dtype=torch.int64, device=dev)
    b = torch.ones(B, dtype=torch.int64, device=dev)
    m = torch.ones(B, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for n in range(_NPAR):
        # d = synd[n] ^ sum_{i=1..T} C[i] * synd[n-i]
        s_prev = torch.where(svalid[n], synd[:, sidx[n]], zero)
        d = synd[:, n] ^ _xor_reduce(_gfv(log_t, antilog_t, C[:, 1:],
                                          s_prev), -1)
        nz = d != 0
        db = _gfv(log_t, antilog_t, d,
                  _ginv(log_t, antilog_t, torch.clamp(b, min=1)))
        # shifted[k] = Bb[k - m] (0 for k < m)
        gather = torch.clamp(kidx[None, :] - m[:, None], 0, _T)
        shifted = torch.where(kidx[None, :] >= m[:, None],
                              torch.gather(Bb, 1, gather), zero)
        delta = _gfv(log_t, antilog_t, db[:, None], shifted)
        C_new = torch.where(nz[:, None], C ^ delta, C)
        grow = nz & (2 * L <= n)
        Bb = torch.where(grow[:, None], C, Bb)
        b = torch.where(grow, d, b)
        L = torch.where(grow, n + 1 - L, L)
        m = torch.where(grow, torch.ones_like(m), m + 1)
        C = C_new

    # --- Omega = S(x) * Lambda(x) mod x^2t ---
    prods = _gfv(log_t, antilog_t, C[:, :, None],
                 synd[:, None, :])                        # [B, T+1, 2t]
    i_idx = torch.arange(_T + 1, device=dev)[None, :]
    gathered = prods[:, i_idx, on(oidx_np, dev)]          # [B, 2t, T+1]
    omega = _xor_reduce(torch.where(on(ovalid_np, dev), gathered, zero),
                        -1)                               # [B, 2t]

    # --- Chien + Forney over all positions at once ---
    lam_eval = _xor_reduce(_gfv(log_t, antilog_t, C[:, None, :],
                                on(lam_np, dev, torch.int64)[None]), -1)
    om_eval = _xor_reduce(_gfv(log_t, antilog_t, omega[:, None, :],
                               on(om_np, dev, torch.int64)[None]), -1)
    dlam_eval = _xor_reduce(_gfv(log_t, antilog_t, C[:, None, :],
                                 on(dlam_np, dev, torch.int64)[None]), -1)
    is_err = (lam_eval == 0) & (dlam_eval != 0)
    inv_dlam = _ginv(log_t, antilog_t, torch.clamp(dlam_eval, min=1))
    mag = _gfv(log_t, antilog_t, om_eval, inv_dlam)
    mag = _gfv(log_t, antilog_t, mag,
               on(xfac_np, dev, torch.int64)[None, :].expand_as(mag))
    err = torch.where(is_err, mag, zero)
    corrected = (blocks ^ err).to(torch.uint8).reshape(-1, nblocks, RS_N)

    out = torch.cat([corrected[:, b, :lens[b]] for b in range(nblocks)],
                    dim=-1)
    return out.reshape(*lead, n_bytes)


# host oracle (exported for tests)
def np_rs_roundtrip_check(msg: np.ndarray) -> bool:
    cw = np.concatenate([msg, _np_parity(msg)])
    return not _np_syndromes(cw).any()
