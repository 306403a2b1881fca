"""Streamwise correlation helpers for the frame detectors.

Port of ``liquid_usrp_tpu/ops/corr.py`` for the OFDM and flexframe
receivers: the FFT-size helper, the host-side frequency response of a
reversed template (correlation as convolution), the reshape-cumsum comb
moving sum of the energy normalizers, and the centered sliding max of the
non-max suppression.  The JAX package picks between two bit-identical
sliding-max forms by backend; the port has one.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["next_pow2", "comb_rev_freq_np", "comb_moving_sum", "sliding_max",
           "topk_peaks", "find_candidates"]


def next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(n, 2))))


def comb_rev_freq_np(kern: np.ndarray, k: int, nfft: int) -> np.ndarray:
    """Frequency response (host numpy) of the time-reversed k-dilated comb
    of ``kern``: with ``Y = ifft(fft(x, nfft) * comb_rev_freq_np(kern, k,
    nfft))`` the correlation ``sum_d kern[d] x[n + k d]`` is ``Y[n + span -
    1]``, ``span = (len(kern) - 1) k + 1``."""
    comb = np.zeros(((len(kern) - 1) * k + 1,), np.complex64)
    comb[::k] = kern
    return np.fft.fft(comb[::-1], nfft).astype(np.complex64)


def comb_moving_sum(x: torch.Tensor, D: int, k: int,
                    n_out: int) -> torch.Tensor:
    """``y[..., n] = sum_{d<D} x[..., n + k d]`` for ``n in [0, n_out)``
    (real ``x``, last axis): a per-residue moving sum on the ``[L/k, k]``
    reshape, as a float32 cumsum difference (JAX's formula; the cumsum's
    rounding order is the backend's)."""
    lead, L = x.shape[:-1], x.shape[-1]
    M = -(-L // k) + D + 1
    X = torch.nn.functional.pad(x, (0, M * k - L)).reshape(*lead, M, k)
    cs = torch.nn.functional.pad(torch.cumsum(X, dim=-2), (0, 0, 1, 0))
    S = cs[..., D:, :] - cs[..., :-D, :]    # S[m, r] = sum_d X[m + d, r]
    return S.reshape(*lead, -1)[..., :n_out]


def sliding_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """``out[..., i] = max(x[..., i-radius : i+radius+1])`` along the last
    axis, with -inf beyond the ends ("SAME" padding).  Max is exact, so
    this equals both JAX forms bit for bit."""
    lead = x.shape[:-1]
    y = torch.nn.functional.max_pool1d(
        x.reshape(-1, 1, x.shape[-1]), kernel_size=2 * radius + 1,
        stride=1, padding=radius)
    return y.reshape(*lead, x.shape[-1])


def topk_peaks(score: torch.Tensor, k: int, min_dist: int):
    """Top-k of an NMS-suppressed score along the last axis via a
    two-stage segmented reduce: after NMS surviving peaks are >=
    ``min_dist`` apart, so segments shorter than that hold at most one
    candidate each; a per-segment max (first argmax on ties) and one top-k
    over the segment maxima replace the full sort.  Returns ``(vals,
    locs int32)``; equal to a full top-k up to the order of equal scores."""
    seg = min(64, min_dist)
    n = score.shape[-1]
    n_seg = -(-n // seg)
    pad = torch.full((*score.shape[:-1], n_seg * seg - n), -1.0,
                     dtype=score.dtype, device=score.device)
    s2 = torch.cat([score, pad], dim=-1).reshape(*score.shape[:-1], n_seg,
                                                 seg)
    seg_max = s2.amax(-1)
    seg_arg = s2.argmax(-1)
    vals, seg_idx = torch.topk(seg_max, k, dim=-1)
    locs = seg_idx * seg + torch.gather(seg_arg, -1, seg_idx)
    return vals, locs.to(torch.int32)


def find_candidates(metric: torch.Tensor, win: int, T: int,
                    threshold: float, k: int):
    """Non-max-suppressed top-k candidate offsets of a detect metric.

    The detect region is ``[win, T + win)``: inset by one NMS radius so
    every candidate has full suppression context on both sides.  Returns
    ``(vals, locs)``; ``vals > 0`` marks a detection."""
    local_max = sliding_max(metric, win)
    is_peak = (metric >= local_max) & (metric > threshold)
    idx = torch.arange(metric.shape[-1], device=metric.device)
    in_region = (idx >= win) & (idx < T + win)
    score = torch.where(is_peak & in_region, metric,
                        torch.full_like(metric, -1.0))
    return topk_peaks(score, k, 2 * win + 1)
