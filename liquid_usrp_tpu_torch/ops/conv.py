"""Convolutional codes (rate 1/R, K up to 15, puncturing) with a batched
Viterbi decoder.

Port of ``liquid_usrp_tpu/ops/conv.py``: ``v27`` (K=7 r=1/2), ``v29`` (K=9
r=1/2), ``v39`` (K=9 r=1/3), ``v615`` (K=15 r=1/6) and the punctured K=7/K=9
variants ``v27p23..v27p78`` / ``v29p23..v29p78``.  The host tables
(``_ConvCode``, ``_PUNCTURE``, ``_params``, ``_coded_bits``, ``_keep_mask``,
``encoded_length``, ``_tables``) are copied verbatim, so code lengths and
trellis tables equal the JAX package's.

The encoder is the integer parity of ``polys & register`` per output bit;
puncturing is a static keep-mask.  The decoder is JAX's terminated-trellis
Viterbi (punctured positions are zero-metric erasures), batched over a
leading row axis where JAX ``vmap``s:

* the branch metric of every output pattern (``2^R`` of them) is computed
  for all trellis steps at once, ``[B, T, 2^R]``, and each state's two
  incoming branches read it through a static pattern-id table;
* the register convention gives every state ``s`` the predecessors
  ``2s mod S`` and ``2s mod S + 1``, so add-compare-select is one
  broadcast add over the ``[B, S/2, 2]`` view of the path metrics, a
  strict ``<`` (JAX's first-index ``argmin`` on ties) and a ``minimum``:
  three launches a step;
* JAX subtracts the minimum path metric after every step; the decisions
  only depend on differences within a row, so the port subtracts it after
  every 256 steps, exactly in int32 (the metrics grow by at most 90 a step
  in between);
* the traceback walks the stored decisions backwards, one gather a step
  (from each step's predecessor table, ``2s mod S + w`` as int64, built
  one chunk of steps at a time so that only the bool decisions are kept
  whole), every row at once.

That loop (:func:`_viterbi_plain`) is the plain version.  On a CUDA tensor
:func:`_viterbi` runs the whole trellis, add-compare-select and traceback,
in one launch of the hand-written kernel ``csrc/viterbi.cu`` (S = 64, 256
or 16,384 states; built by :mod:`._build`), counted in
``kernels.launches["viterbi"]``; there is no fallback.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.bits import pack_bits, unpack_bits
from ..utils.consts import on
from ..utils.profiling import count
from . import kernels

__all__ = ["encoded_length", "conv_encode", "conv_decode",
           "conv_decode_soft"]

_BM_ELEMS = 1 << 22         # branch-metric entries gathered per chunk
# steps between two subtractions of each row's least path metric in the
# plain version (the bits do not depend on it while int32 holds the sums)
_RENORM = 256


class _ConvCode(NamedTuple):
    K: int                 # constraint length
    polys: tuple           # R generator polynomials (K taps each)
    puncture: Optional[tuple]  # flattened keep pattern over R*period bits


# standard puncturing patterns (keep masks per R=2 output pair, row-major
# over the pattern period)
_PUNCTURE = {
    "23": (1, 1, 1, 0),
    "34": (1, 1, 1, 0, 0, 1),
    "45": (1, 1, 1, 0, 1, 0, 1, 0),
    "56": (1, 1, 1, 0, 0, 1, 1, 0, 0, 1),
    "67": (1, 1, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1),
    "78": (1, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1),
}


@functools.lru_cache(maxsize=None)
def _params(scheme: int) -> _ConvCode:
    from . import fec
    base = {
        fec.FEC_CONV_V27: _ConvCode(7, (0o171, 0o133), None),
        fec.FEC_CONV_V29: _ConvCode(9, (0o561, 0o753), None),
        fec.FEC_CONV_V39: _ConvCode(9, (0o557, 0o663, 0o711), None),
        fec.FEC_CONV_V615: _ConvCode(
            15, (0o46321, 0o51271, 0o63667, 0o70535, 0o73277, 0o61731),
            None),
    }
    if scheme in base:
        return base[scheme]
    for rate, pat in _PUNCTURE.items():
        if scheme == getattr(fec, f"FEC_CONV_V27P{rate}"):
            return _ConvCode(7, (0o171, 0o133), pat)
        if scheme == getattr(fec, f"FEC_CONV_V29P{rate}"):
            return _ConvCode(9, (0o561, 0o753), pat)
    raise ValueError(f"not a conv scheme: {scheme}")


def _coded_bits(p: _ConvCode, nbits: int) -> int:
    """Kept output bits for ``nbits`` terminated input bits."""
    total = len(p.polys) * nbits
    if p.puncture is None:
        return total
    pat = np.asarray(p.puncture)
    period = len(pat)
    full, rem = divmod(total, period)
    return int(full * pat.sum() + pat[:rem].sum())


def _keep_mask(p: _ConvCode, total: int) -> np.ndarray:
    if p.puncture is None:
        return np.ones(total, dtype=bool)
    pat = np.asarray(p.puncture, dtype=bool)
    reps = -(-total // len(pat))
    return np.tile(pat, reps)[:total]


def encoded_length(scheme: int, n_bytes: int) -> int:
    p = _params(scheme)
    nbits = n_bytes * 8 + (p.K - 1)               # terminated
    return -(-_coded_bits(p, nbits) // 8)


@functools.lru_cache(maxsize=None)
def _tables(scheme: int):
    """Per-state branch tables.

    Register convention: r = [b_t, ..., b_{t-K+1}] with b_t in bit K-1;
    state = r >> 1; outputs o_j = parity(polys[j] & r); next = r >> 1 after
    shifting in the new bit at the top.
    """
    p = _params(scheme)
    S = 1 << (p.K - 1)
    R = len(p.polys)
    out = np.zeros((S, 2, R), dtype=np.uint8)
    nxt = np.zeros((S, 2), dtype=np.int32)
    for s in range(S):
        for b in (0, 1):
            reg = (b << (p.K - 1)) | s
            for j, g in enumerate(p.polys):
                out[s, b, j] = bin(reg & g).count("1") & 1
            nxt[s, b] = reg >> 1
    pred = np.zeros((S, 2), dtype=np.int32)
    pred_bit = np.zeros((S, 2), dtype=np.uint8)
    cnt = np.zeros(S, dtype=np.int32)
    for s in range(S):
        for b in (0, 1):
            ns = nxt[s, b]
            pred[ns, cnt[ns]] = s
            pred_bit[ns, cnt[ns]] = b
            cnt[ns] += 1
    assert (cnt == 2).all()
    pred_out = np.zeros((S, 2, R), dtype=np.uint8)
    for ns in range(S):
        for w in (0, 1):
            pred_out[ns, w] = out[pred[ns, w], pred_bit[ns, w]]
    return pred, pred_bit, pred_out, S, p.K, R


@functools.lru_cache(maxsize=None)
def _trellis(scheme: int):
    """Device-side trellis tables: ``(pid [S*2] int64, patterns [2^R, R]
    int32, base [S] int64)``.  ``pid[2 ns + w]`` is the output pattern
    (bits MSB-first as an integer) of the branch from ``pred[ns, w]`` into
    ``ns``; ``base[ns] = 2 ns mod S`` is its first predecessor.  Checks the
    predecessor structure the decoder's views rely on."""
    pred, pred_bit, pred_out, S, K, R = _tables(scheme)
    ns = np.arange(S)
    assert np.array_equal(pred, ((2 * ns) % S)[:, None] + np.arange(2))
    assert np.array_equal(pred_bit, np.repeat((ns >> (K - 2))[:, None], 2,
                                              axis=1))
    weights = 1 << np.arange(R - 1, -1, -1)
    pid = (pred_out.astype(np.int64) * weights).sum(-1).reshape(-1)
    pats = ((np.arange(1 << R)[:, None] >> np.arange(R - 1, -1, -1)) & 1)
    base = ((2 * ns) % S).astype(np.int64)
    return pid, pats.astype(np.int32), base


@functools.lru_cache(maxsize=None)
def _kept_index(scheme: int, total: int) -> np.ndarray:
    return np.nonzero(_keep_mask(_params(scheme), total))[0]


def conv_encode(scheme: int, data: torch.Tensor) -> torch.Tensor:
    """Encode uint8 ``[..., n]`` -> uint8 ``[..., encoded_length]``
    (terminated)."""
    p = _params(scheme)
    K, R = p.K, len(p.polys)
    dev = data.device
    lead = data.shape[:-1]
    bits = unpack_bits(data).to(torch.int32)
    nbits = bits.shape[-1] + K - 1
    # x = [K-1 zeros | bits | K-1 flush zeros]; windows[t, j] = x[t + j]
    x = torch.nn.functional.pad(bits, (K - 1, K - 1))
    windows = x.unfold(-1, K, 1)                          # [..., nbits, K]
    # windows[..., j] = x[t - (K-1-j)]; coefficient of x[t-i] is g bit
    # (K-1-i), so tap j is g bit j
    taps = torch.tensor([[(g >> j) & 1 for j in range(K)] for g in p.polys],
                        dtype=torch.int32, device=dev)    # [R, K]
    par = (windows[..., None, :] * taps).sum(-1) & 1      # [..., nbits, R]
    inter = par.reshape(*lead, nbits * R)                 # o0..oR-1
    kept = inter[..., on(_kept_index(scheme, nbits * R), dev)]
    pad = encoded_length(scheme, data.shape[-1]) * 8 - kept.shape[-1]
    if pad:
        kept = torch.nn.functional.pad(kept, (0, pad))
    return pack_bits(kept.to(torch.uint8))


@functools.lru_cache(maxsize=None)
def _keep_i32(scheme: int, total: int) -> np.ndarray:
    return _keep_mask(_params(scheme), total).astype(np.int32)


def _depuncture(scheme: int, vals: torch.Tensor, nbits: int, R: int):
    """Kept values ``[B, nkept]`` -> full-rate ``[B, nbits, R]`` with zeros
    at the punctured positions, and the keep mask ``[nbits, R]`` (int32;
    ``None`` for an unpunctured code)."""
    total = R * nbits
    idx = _kept_index(scheme, total)
    if len(idx) == total:
        return vals[:, :total].reshape(-1, nbits, R), None
    dev = vals.device
    full = torch.zeros((vals.shape[0], total), dtype=vals.dtype, device=dev)
    full[:, on(idx, dev)] = vals[:, :len(idx)]
    return (full.reshape(-1, nbits, R),
            on(_keep_i32(scheme, total), dev).reshape(nbits, R))


@functools.lru_cache(maxsize=None)
def _butterflies(scheme: int) -> np.ndarray:
    """The kernel's pattern ids: int32 ``[S/2]``, butterfly ``s'`` (the
    predecessors ``2s'`` and ``2s'+1`` of the states ``s'`` and ``s'+S/2``)
    holding ``pid[2s']``, ``pid[2s'+1]``, ``pid[2(s'+S/2)]`` and
    ``pid[2(s'+S/2)+1]`` in its bytes 0-3."""
    pid, _, _ = _trellis(scheme)
    p = pid.reshape(2, -1, 2)                  # [h, s', w]
    return (p[0, :, 0] | p[0, :, 1] << 8 | p[1, :, 0] << 16 |
            p[1, :, 1] << 24).astype(np.int32)


def _viterbi(scheme: int, bm_pat: torch.Tensor, big: int) -> torch.Tensor:
    """Terminated-trellis Viterbi over rows: ``bm_pat [B, T, 2^R]`` int32
    branch costs per output pattern (lower is better), every state but 0
    starting at ``big`` -> decoded bits ``[B, T]`` uint8 (the last K-1 are
    the flush zeros).  A CPU tensor runs :func:`_viterbi_plain`; a CUDA
    tensor launches ``csrc/viterbi.cu`` (``bm_pat`` contiguous int32) or
    raises; a launch is counted in ``kernels.launches["viterbi"]``.  Counts
    the ``T`` sequential steps as ``viterbi_steps``."""
    count("viterbi_steps", bm_pat.shape[1])
    if bm_pat.device.type == "cpu":
        return _viterbi_plain(scheme, bm_pat, big)
    if bm_pat.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {bm_pat.device}")
    if bm_pat.dtype != torch.int32:
        raise TypeError(f"branch costs must be int32, got {bm_pat.dtype}")
    if not bm_pat.is_contiguous():
        raise ValueError("branch costs must be contiguous")
    S = 1 << (_params(scheme).K - 1)
    B, T, P = bm_pat.shape
    if P != 1 << len(_params(scheme).polys):
        raise ValueError(f"{P} output patterns for a rate-1/"
                         f"{len(_params(scheme).polys)} code")
    dev = bm_pat.device
    bits = torch.empty((B, T), dtype=torch.uint8, device=dev)
    if not B or not T:
        return bits
    geometry = dict(scheme=scheme, rows=B, steps=T, states=S)
    scratch = kernels._scratch("viterbi_scratch", dev, geometry, B, T, S, P)
    kernels._launch("viterbi_launch", bm_pat, geometry, bm_pat.data_ptr(),
                    B, T, S, P, on(_butterflies(scheme), dev).data_ptr(),
                    big, kernels._ptr(scratch), bits.data_ptr())
    kernels.launches["viterbi"] += 1
    return bits


def _viterbi_plain(scheme: int, bm_pat: torch.Tensor, big: int
                   ) -> torch.Tensor:
    """Plain PyTorch version of :func:`_viterbi`: the trellis as a loop of
    eager steps, every row at once, renormalising every ``_RENORM``
    steps."""
    pid_np, _, base_np = _trellis(scheme)
    S = base_np.shape[0]
    K = int(np.log2(S)) + 1
    B, T, _ = bm_pat.shape
    dev = bm_pat.device
    pid = on(pid_np, dev)
    # path metrics and the candidates in fixed buffers, with every view the
    # steps read or write made once: the loop's host work per step is its
    # three launches
    pm = torch.full((B, S), big, dtype=torch.int32, device=dev)
    pm[:, 0] = 0
    pm_in = pm.view(B, 1, S // 2, 2)          # pm[b, 2 s' + w]
    pm_out = pm.view(B, 2, S // 2)            # pm[b, h S/2 + s']
    cand = torch.empty((B, 2, S // 2, 2), dtype=torch.int32, device=dev)
    c0, c1 = cand.unbind(-1)
    choices = torch.empty((T, B, 2, S // 2), dtype=torch.bool, device=dev)
    chosen = choices.unbind(0)
    chunk = max(1, min(256, _BM_ELEMS // max(1, B * 2 * S)))
    renorm = _RENORM
    for t0 in range(0, T, chunk):
        # both incoming branch costs of every state, per step: [B, 2, S/2, 2]
        bms = bm_pat[:, t0:t0 + chunk].index_select(-1, pid).reshape(
            B, -1, 2, S // 2, 2).unbind(1)
        for t, bm in enumerate(bms, t0):
            # cand[b, h, s', w] = pm[b, 2 s' + w] + bm: the predecessors of
            # ns = h S/2 + s' are 2 s' and 2 s' + 1
            torch.add(pm_in, bm, out=cand)
            torch.lt(c1, c0, out=chosen[t])
            torch.minimum(c0, c1, out=pm_out)
            if (t + 1) % renorm == 0:
                pm.sub_(pm.amin(-1, keepdim=True))
    # traceback from state 0: the state before step t is 2 s mod S + w,
    # one gather a step straight into the next step's index, from a
    # predecessor table built per chunk of steps (int64, so one chunk's)
    base = on(base_np, dev)
    states = torch.zeros((T, B, 1), dtype=torch.int64, device=dev)
    st = states.unbind(0)
    for t1 in range(T, 1, -chunk):
        t0 = max(1, t1 - chunk)
        prev = (choices[t0:t1].view(-1, B, S).to(torch.int64) |
                base).unbind(0)
        for t in range(t1 - 1, t0 - 1, -1):
            torch.gather(prev[t - t0], 1, st[t], out=st[t - 1])
    # the decoded bit of step t is the top bit of the state it enters
    return (states[..., 0].t() >> (K - 2)).to(torch.uint8)


def _rows(x: torch.Tensor):
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


# the path metric every state but 0 starts at: hard and soft costs
BIG_HARD, BIG_SOFT = 1 << 20, 1 << 24


def _hard_costs(scheme: int, flat: torch.Tensor, n_bytes: int
                ) -> torch.Tensor:
    """Hard-decision branch costs ``[B, T, 2^R]`` int32 of coded rows
    ``[B, n_coded]``: each pattern's Hamming distance to the received bits,
    punctured positions counting 0."""
    p = _params(scheme)
    K, R = p.K, len(p.polys)
    _, pats, _ = _trellis(scheme)
    nbits = n_bytes * 8 + (K - 1)
    rx, mask = _depuncture(scheme, unpack_bits(flat).to(torch.int32), nbits,
                           R)
    diff = (on(pats, flat.device) - rx[:, :, None, :]).abs()
    if mask is not None:
        diff = diff * mask[:, None, :]
    return diff.sum(-1, dtype=torch.int32)


def conv_decode(scheme: int, coded: torch.Tensor, n_bytes: int
                ) -> torch.Tensor:
    """Hard-decision Viterbi decode ``[..., n_coded]`` -> uint8 ``[...,
    n_bytes]``.  Punctured positions are treated as erasures (zero branch
    metric)."""
    flat, lead = _rows(coded)
    bits = _viterbi(scheme, _hard_costs(scheme, flat, n_bytes), BIG_HARD)
    return pack_bits(bits[:, :n_bytes * 8]).reshape(*lead, n_bytes)


def _soft_costs(scheme: int, flat: torch.Tensor, n_bytes: int
                ) -> torch.Tensor:
    """Soft-decision branch costs ``[B, T, 2^R]`` int32 of LLR rows ``[B,
    >= encoded_length * 8]`` (see :func:`conv_decode_soft`)."""
    p = _params(scheme)
    K, R = p.K, len(p.polys)
    _, pats, _ = _trellis(scheme)
    nbits = n_bytes * 8 + (K - 1)
    nkept = len(_kept_index(scheme, R * nbits))
    L = flat[:, :nkept].to(torch.float32)
    absL = L.abs()
    live = absL > 1e-6 * torch.clamp(absL.amax(-1, keepdim=True), min=1e-9)
    mean_live = (absL * live).sum(-1, keepdim=True) / torch.clamp(
        live.sum(-1, keepdim=True).to(torch.float32), min=1.0)
    scale = 7.0 / torch.clamp(mean_live, min=1e-9)
    q = torch.clamp(torch.round(L * scale), -15, 15).to(torch.int32)
    rx, _ = _depuncture(scheme, q, nbits, R)
    sgn = 1 - 2 * on(pats, flat.device)                   # [2^R, R]
    return (sgn * rx[:, :, None, :]).sum(-1, dtype=torch.int32)


def conv_decode_soft(scheme: int, llr_bits: torch.Tensor,
                     n_bytes: int) -> torch.Tensor:
    """Soft-decision Viterbi decode from per-bit LLRs (positive => bit 1).

    ``llr_bits``: float32 ``[..., encoded_length * 8]`` in wire order (kept
    bits only; punctured positions are re-inserted as zero-confidence
    erasures).  Branch metric: correlation cost ``sum (1 - 2 e_j) *
    llr_j`` of LLRs quantized to 5-bit ints, scaled per row by the mean
    magnitude of its live entries (see the JAX docstring)."""
    flat, lead = _rows(llr_bits)
    bits = _viterbi(scheme, _soft_costs(scheme, flat, n_bytes), BIG_SOFT)
    return pack_bits(bits[:, :n_bytes * 8]).reshape(*lead, n_bytes)
