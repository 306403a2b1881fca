"""Forward error correction: the block codes as GF(2) matmul + syndrome
gather kernels, and the dispatch to the convolutional and Reed-Solomon
codecs.

Port of ``liquid_usrp_tpu/ops/fec.py`` with hard-decision decoding: none,
rep3/5, Hamming(7,4)/(8,4)/(12,8), Golay(24,12), SEC-DED(22,16)/(39,32)/
(72,64), the convolutional codes (``ops/conv.py``: v27, v29, v39, v615
and the punctured v27/v29 variants) and RS(255,223) (``ops/rs.py``).
Scheme ids and names equal the JAX package's.  The NumPy functions that
build the tables are copied verbatim, so the tables are equal by
construction (the tests compare them).  ``golay_decode_soft`` is the
exact maximum-likelihood soft decoder of Golay(24,12) for the soft header.

Layout: messages are encoded MSB-first; the bit stream is chopped into
``k``-bit blocks (zero-padded at the end), each block maps to ``n`` coded
bits, and the coded stream is zero-padded up to a whole byte.
"""
from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.bits import gf2_matmul, pack_bits, unpack_bits
from ..utils.consts import on

__all__ = [
    "FEC_NONE", "FEC_REP3", "FEC_REP5",
    "FEC_HAMMING74", "FEC_HAMMING84", "FEC_HAMMING128",
    "FEC_GOLAY2412",
    "FEC_SECDED2216", "FEC_SECDED3932", "FEC_SECDED7264",
    "FEC_CONV_V27", "FEC_CONV_V29", "FEC_RS8",
    "fec_names", "fec_from_name", "fec_name",
    "encoded_length", "fec_encode", "fec_decode", "golay_decode_soft",
]

FEC_NONE = 0
FEC_REP3 = 1
FEC_REP5 = 2
FEC_HAMMING74 = 3
FEC_HAMMING84 = 4
FEC_HAMMING128 = 5
FEC_GOLAY2412 = 6
FEC_SECDED2216 = 7
FEC_SECDED3932 = 8
FEC_SECDED7264 = 9
FEC_CONV_V27 = 10
FEC_CONV_V29 = 11
FEC_RS8 = 12
FEC_CONV_V39 = 13
FEC_CONV_V615 = 14
FEC_CONV_V27P23 = 15
FEC_CONV_V27P34 = 16
FEC_CONV_V27P45 = 17
FEC_CONV_V27P56 = 18
FEC_CONV_V27P67 = 19
FEC_CONV_V27P78 = 20
FEC_CONV_V29P23 = 21
FEC_CONV_V29P34 = 22
FEC_CONV_V29P45 = 23
FEC_CONV_V29P56 = 24
FEC_CONV_V29P67 = 25
FEC_CONV_V29P78 = 26

_NAMES = {
    FEC_NONE: "none", FEC_REP3: "rep3", FEC_REP5: "rep5",
    FEC_HAMMING74: "h74", FEC_HAMMING84: "h84", FEC_HAMMING128: "h128",
    FEC_GOLAY2412: "g2412",
    FEC_SECDED2216: "secded2216", FEC_SECDED3932: "secded3932",
    FEC_SECDED7264: "secded7264",
    FEC_CONV_V27: "v27", FEC_CONV_V29: "v29",
    FEC_RS8: "rs8",
    FEC_CONV_V39: "v39", FEC_CONV_V615: "v615",
    FEC_CONV_V27P23: "v27p23", FEC_CONV_V27P34: "v27p34",
    FEC_CONV_V27P45: "v27p45", FEC_CONV_V27P56: "v27p56",
    FEC_CONV_V27P67: "v27p67", FEC_CONV_V27P78: "v27p78",
    FEC_CONV_V29P23: "v29p23", FEC_CONV_V29P34: "v29p34",
    FEC_CONV_V29P45: "v29p45", FEC_CONV_V29P56: "v29p56",
    FEC_CONV_V29P67: "v29p67", FEC_CONV_V29P78: "v29p78",
}
_BY_NAME = {v: k for k, v in _NAMES.items()}
_BY_NAME.update({"hamming74": FEC_HAMMING74, "hamming84": FEC_HAMMING84,
                 "hamming128": FEC_HAMMING128, "golay2412": FEC_GOLAY2412})


def fec_names():
    return list(_NAMES.values())


def fec_from_name(name: str) -> int:
    try:
        return _BY_NAME[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown FEC scheme '{name}'; supported: {fec_names()}")


def fec_name(scheme: int) -> str:
    return _NAMES[scheme]


class _BlockCode(NamedTuple):
    k: int                  # data bits per block
    n: int                  # coded bits per block
    G: np.ndarray           # [k, n] systematic generator, G = [I_k | P]
    H: np.ndarray           # [n-k, n] parity check, H = [P^T | I_{n-k}]
    syn_table: np.ndarray   # [2^(n-k), n] syndrome -> error pattern


def _H_from_G(G: np.ndarray) -> np.ndarray:
    k, n = G.shape
    return np.concatenate([G[:, k:].T, np.eye(n - k, dtype=np.uint8)], axis=1)


def _syndrome_int(H: np.ndarray, e: np.ndarray) -> int:
    s_bits = (H @ e) % 2
    s = 0
    for b in s_bits:
        s = (s << 1) | int(b)
    return s


def _single_error_table(H: np.ndarray) -> np.ndarray:
    """Syndrome table correcting single-bit errors (first column match wins)."""
    r, n = H.shape
    syn_table = np.zeros((1 << r, n), dtype=np.uint8)
    for pos in range(n):
        e = np.zeros(n, dtype=np.uint8)
        e[pos] = 1
        s = _syndrome_int(H, e)
        if s and not syn_table[s].any():
            syn_table[s, pos] = 1
    return syn_table


def _systematic_from_H_cols(a_cols: list[int], r: int) -> _BlockCode:
    """Systematic SEC code from the non-unit columns of ``H = [A | I_r]``."""
    k = len(a_cols)
    A = np.zeros((r, k), dtype=np.uint8)
    for j, c in enumerate(a_cols):
        for i in range(r):
            A[i, j] = (c >> (r - 1 - i)) & 1
    G = np.concatenate([np.eye(k, dtype=np.uint8), A.T], axis=1)
    H = _H_from_G(G)
    return _BlockCode(k, k + r, G, H, _single_error_table(H))


def _extend_parity(code: _BlockCode) -> _BlockCode:
    """Add an overall parity bit (SEC -> SEC-DED extension)."""
    k, n = code.k, code.n
    G = np.concatenate(
        [code.G, (code.G.sum(axis=1) % 2)[:, None].astype(np.uint8)], axis=1)
    H = _H_from_G(G)
    return _BlockCode(k, n + 1, G, H, _single_error_table(H))


def _golay_code() -> _BlockCode:
    """Extended binary Golay (24,12,8): G = [I | B], corrects 3 errors."""
    qr = {1, 3, 4, 5, 9}  # quadratic residues mod 11
    B = np.zeros((12, 12), dtype=np.uint8)
    for i in range(11):
        for j in range(11):
            B[i, j] = 1 if ((j - i) % 11) in qr else 0
        B[i, 11] = 1
        B[11, i] = 1
    B[11, 11] = 0
    G = np.concatenate([np.eye(12, dtype=np.uint8), B], axis=1)
    H = _H_from_G(G)

    syn_table = np.zeros((1 << 12, 24), dtype=np.uint8)
    seen = np.zeros(1 << 12, dtype=bool)
    # enumerate error patterns by increasing weight; first writer wins
    for w in range(0, 5):
        for pos in itertools.combinations(range(24), w):
            e = np.zeros(24, dtype=np.uint8)
            e[list(pos)] = 1
            s = _syndrome_int(H, e)
            if not seen[s]:
                seen[s] = True
                syn_table[s] = e
        if seen.all():
            break
    if not seen.all():
        raise RuntimeError("Golay syndrome table incomplete")
    return _BlockCode(12, 24, G, H, syn_table)


@functools.lru_cache(maxsize=None)
def _block_code(scheme: int) -> _BlockCode:
    if scheme == FEC_HAMMING74:
        return _systematic_from_H_cols([0b011, 0b101, 0b110, 0b111], 3)
    if scheme == FEC_HAMMING84:
        return _extend_parity(_block_code(FEC_HAMMING74))
    if scheme == FEC_HAMMING128:
        return _systematic_from_H_cols(
            [0b0011, 0b0101, 0b0110, 0b0111, 0b1001, 0b1010, 0b1011, 0b1100],
            4)
    if scheme == FEC_GOLAY2412:
        return _golay_code()
    if scheme == FEC_SECDED2216:
        cols = [c for c in range(3, 32) if bin(c).count("1") >= 2][:16]
        return _extend_parity(_systematic_from_H_cols(cols, 5))
    if scheme == FEC_SECDED3932:
        cols = [c for c in range(3, 64) if bin(c).count("1") >= 2][:32]
        return _extend_parity(_systematic_from_H_cols(cols, 6))
    if scheme == FEC_SECDED7264:
        cols = [c for c in range(3, 128) if bin(c).count("1") >= 2][:64]
        return _extend_parity(_systematic_from_H_cols(cols, 7))
    raise ValueError(f"not a block code scheme: {scheme}")


@functools.lru_cache(maxsize=None)
def _HT(scheme: int) -> np.ndarray:
    return np.ascontiguousarray(_block_code(scheme).H.T)


def _is_rep(scheme):
    return scheme in (FEC_REP3, FEC_REP5)


def _is_conv(scheme):
    return FEC_CONV_V27 <= scheme <= FEC_CONV_V29 or \
        FEC_CONV_V39 <= scheme <= FEC_CONV_V29P78


def encoded_length(scheme: int, n_bytes: int) -> int:
    """Encoded size in bytes for an ``n_bytes`` input message."""
    if scheme == FEC_NONE:
        return n_bytes
    if scheme == FEC_RS8:
        from . import rs
        return rs.rs_encoded_length(n_bytes)
    if scheme == FEC_REP3:
        return 3 * n_bytes
    if scheme == FEC_REP5:
        return 5 * n_bytes
    if _is_conv(scheme):
        from . import conv
        return conv.encoded_length(scheme, n_bytes)
    c = _block_code(scheme)
    nbits = n_bytes * 8
    nblocks = -(-nbits // c.k)
    return -(-(nblocks * c.n) // 8)


def fec_encode(scheme: int, data: torch.Tensor) -> torch.Tensor:
    """Encode uint8 ``[..., n]`` -> uint8 ``[..., encoded_length(n)]``."""
    if scheme == FEC_NONE:
        return data
    if scheme == FEC_RS8:
        from . import rs
        return rs.rs_encode(data)
    if _is_rep(scheme):
        # byte-local repetition: each byte r times consecutively
        r = 3 if scheme == FEC_REP3 else 5
        return torch.repeat_interleave(data, r, dim=-1)
    if _is_conv(scheme):
        from . import conv
        return conv.conv_encode(scheme, data)
    c = _block_code(scheme)
    nbits = data.shape[-1] * 8
    nblocks = -(-nbits // c.k)
    bits = unpack_bits(data)
    pad = nblocks * c.k - nbits
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    blocks = bits.reshape(*bits.shape[:-1], nblocks, c.k)
    coded = gf2_matmul(blocks, on(c.G, data.device))
    flat = coded.reshape(*coded.shape[:-2], nblocks * c.n)
    pad2 = encoded_length(scheme, data.shape[-1]) * 8 - flat.shape[-1]
    if pad2:
        flat = torch.nn.functional.pad(flat, (0, pad2))
    return pack_bits(flat)


@functools.lru_cache(maxsize=None)
def _golay_codewords_pm1() -> np.ndarray:
    """All 4096 Golay(24,12) codewords as ±1 rows ``[4096, 24]``."""
    c = _block_code(FEC_GOLAY2412)
    msgs = np.arange(1 << 12, dtype=np.uint32)
    mbits = ((msgs[:, None] >> np.arange(11, -1, -1)) & 1).astype(np.uint8)
    cw = (mbits @ c.G) % 2
    return (2.0 * cw - 1.0).astype(np.float32)


def _golay_scores(llr_blocks: torch.Tensor) -> torch.Tensor:
    """Codeword correlations ``llr [..., 24] @ cw.T`` -> float64
    ``[..., 4096]``.

    The product runs in float64.  Each term is a float32 LLR times ±1, so
    the sum is exact unless one block's LLRs span more than 2^24 in
    magnitude, and no setting of the process touches it: TF32
    (``torch.backends.cuda.matmul.allow_tf32``) and
    ``torch.set_float32_matmul_precision`` act on float32 matmuls only.
    At TF32 the card would round the LLRs to 10-bit mantissas and flip the
    argmax on near-ties."""
    cw = on(_golay_codewords_pm1(), llr_blocks.device, torch.float64)
    return llr_blocks.to(torch.float64) @ cw.T


def golay_decode_soft(llr_blocks: torch.Tensor) -> torch.Tensor:
    """Exact maximum-likelihood soft decode of Golay(24,12).

    ``llr_blocks [..., 24]`` float LLRs (positive => bit 1) -> message bits
    ``[..., 12]`` uint8: the argmax (first maximum on ties, as
    ``jnp.argmax``) over the correlations with all 4096 ±1 codewords, one
    dense ``[..., 24] @ [24, 4096]`` product in float64
    (:func:`_golay_scores`).  The JAX package sums in float32, so the two
    agree except on blocks whose two best scores lie within float32
    rounding of each other."""
    best = torch.argmax(_golay_scores(llr_blocks), dim=-1)
    shifts = torch.arange(11, -1, -1, device=llr_blocks.device)
    return ((best[..., None] >> shifts) & 1).to(torch.uint8)


def fec_decode(scheme: int, coded: torch.Tensor, n_bytes: int
               ) -> torch.Tensor:
    """Hard-decision decode ``[..., encoded_length(n_bytes)]`` -> uint8
    ``[..., n_bytes]`` (syndrome table for the block codes, bitwise
    majority for repetition, Viterbi for the convolutional codes,
    Berlekamp-Massey for RS; every leading axis is a batch axis)."""
    if scheme == FEC_NONE:
        return coded[..., :n_bytes]
    if scheme == FEC_RS8:
        from . import rs
        return rs.rs_decode(coded, n_bytes)
    if _is_conv(scheme):
        from . import conv
        return conv.conv_decode(scheme, coded, n_bytes)
    lead = coded.shape[:-1]
    if _is_rep(scheme):
        r = 3 if scheme == FEC_REP3 else 5
        copies = coded[..., : n_bytes * r].reshape(*lead, n_bytes, r)
        bits = unpack_bits(copies).reshape(*lead, n_bytes, r, 8)
        maj = bits.to(torch.int32).sum(-2) * 2 > r
        return pack_bits(maj.to(torch.uint8).reshape(*lead, n_bytes * 8))
    c = _block_code(scheme)
    nbits = n_bytes * 8
    nblocks = -(-nbits // c.k)
    bits = unpack_bits(coded)[..., :nblocks * c.n]
    blocks = bits.reshape(*lead, nblocks, c.n)
    syn_bits = gf2_matmul(blocks, on(_HT(scheme), coded.device))
    weights = torch.tensor([1 << (c.n - c.k - 1 - i)
                            for i in range(c.n - c.k)],
                           dtype=torch.int64, device=coded.device)
    syn = (syn_bits.to(torch.int64) * weights).sum(-1)
    err = on(c.syn_table, coded.device)[syn]     # gather [..., nblocks, n]
    corrected = blocks ^ err
    data_bits = corrected[..., :c.k].reshape(*lead, nblocks * c.k)[
        ..., :nbits]
    return pack_bits(data_bits)
