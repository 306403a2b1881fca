"""Filter design for the polyphase channelizer (host-side NumPy, float64).

Copied from ``liquid_usrp_tpu/ops/filter_design.py`` — only what
``pfb_channelizer_prototype`` needs (the Kaiser-windowed lowpass design);
the tests compare its output with the JAX package's.  Importing the JAX
package would import jax, which the port never does.
"""
from __future__ import annotations

import numpy as np

__all__ = ["kaiser_beta", "firdes_kaiser", "pfb_channelizer_prototype"]


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
