"""Filter design (host-side NumPy, float64).

Copied from ``liquid_usrp_tpu/ops/filter_design.py`` — only what the ported
paths need: the Kaiser-windowed lowpass design behind
``pfb_channelizer_prototype`` and the resamplers, the root raised-cosine
pulse of the single-carrier frames (``rrcos``), the half-band filter of
the 2x stages (``halfband_kaiser``) and the Gaussian pulse of the GMSK
frames (``gaussian_pulse``); the tests compare their output with
the JAX package's.  Importing the JAX package would import jax, which the
port never does.
"""
from __future__ import annotations

import numpy as np

__all__ = ["kaiser_beta", "firdes_kaiser", "rrcos", "halfband_kaiser",
           "pfb_channelizer_prototype", "gaussian_pulse"]


def kaiser_beta(As: float) -> float:
    """Kaiser window beta for a target stopband attenuation ``As`` dB."""
    As = abs(As)
    if As > 50.0:
        return 0.1102 * (As - 8.7)
    if As > 21.0:
        return 0.5842 * (As - 21.0) ** 0.4 + 0.07886 * (As - 21.0)
    return 0.0


def firdes_kaiser(n: int, fc: float, As: float, mu: float = 0.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass: ``n`` taps, cutoff ``fc`` (cycles/sample,
    0 < fc <= 0.5), stopband ``As`` dB, fractional delay ``mu``."""
    beta = kaiser_beta(As)
    t = np.arange(n) - (n - 1) / 2.0 + mu
    h = 2 * fc * np.sinc(2 * fc * t)
    return h * np.kaiser(n, beta)


def rrcos(k: int, m: int, beta: float) -> np.ndarray:
    """Root raised-cosine: ``k`` samples/symbol, ``2*k*m+1`` taps, rolloff
    ``beta``; unit symbol-rate energy normalization (h[center] peak)."""
    n = 2 * k * m + 1
    t = (np.arange(n) - (n - 1) / 2.0) / k
    h = np.zeros(n)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - beta + 4 * beta / np.pi
        elif beta > 0 and abs(abs(ti) - 1.0 / (4 * beta)) < 1e-9:
            h[i] = (beta / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            num = (np.sin(np.pi * ti * (1 - beta))
                   + 4 * beta * ti * np.cos(np.pi * ti * (1 + beta)))
            den = np.pi * ti * (1 - (4 * beta * ti) ** 2)
            h[i] = num / den
    # normalize so the matched-filter cascade has unity gain at t=0
    return h / np.sqrt(np.sum(h ** 2))


def halfband_kaiser(m: int, As: float) -> np.ndarray:
    """Half-band filter: ``4*m+1`` taps, odd taps zero except center = 0.5
    (the 2x interp/decim stages; DC gain ~1, interpolation scales by 2)."""
    n = 4 * m + 1
    h = firdes_kaiser(n, 0.25, As)
    # enforce exact half-band structure
    for i in range(n):
        t = i - (n - 1) // 2
        if t != 0 and t % 2 == 0:
            h[i] = 0.0
    h[(n - 1) // 2] = 0.5
    return h


def pfb_channelizer_prototype(num_channels: int, m: int,
                              As: float) -> np.ndarray:
    """Kaiser prototype for an ``M``-channel critically sampled filterbank.

    ``2*M*m`` taps, cutoff at the channel half-width 0.5/M (matching the
    firpfbch kaiser design surface: 2N channels, semi-length m, As dB;
    the reference's lib/multichanneltx.cc:85-87).
    """
    M = num_channels
    n = 2 * M * m
    h = firdes_kaiser(n, 0.5 / M, As)
    return h / np.sum(h) * M  # unity passband gain per channel


def gaussian_pulse(k: int, m: int, bt: float) -> np.ndarray:
    """Gaussian lowpass pulse for GMSK: BT product ``bt``, ``2*k*m+1`` taps,
    normalized to unit area (phase pulse integrates to 1/2 per symbol via the
    modulator's scaling)."""
    n = 2 * k * m + 1
    t = (np.arange(n) - (n - 1) / 2.0) / k
    alpha = np.sqrt(np.log(2.0) / 2.0) / bt
    h = (np.sqrt(np.pi) / alpha) * np.exp(-(np.pi * t / alpha) ** 2)
    return h / np.sum(h)
