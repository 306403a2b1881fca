"""Filter and pulse design (host-side NumPy and SciPy, float64).

Copied verbatim from ``liquid_usrp_tpu/ops/filter_design.py``: the
Kaiser-windowed lowpass design behind ``pfb_channelizer_prototype`` and
the resamplers, the root raised-cosine pulse of the single-carrier frames
(``rrcos``), the half-band filter of the 2x stages (``halfband_kaiser``),
the Gaussian pulse of the GMSK frames (``gaussian_pulse``), and the
matched-filter prototypes of ``narrowband_tx -t`` (``firdes_prototype``
over ``PULSE_TYPES``: the root-Nyquist designs from a shaped spectrum, the
rkaiser/arkaiser search with SciPy's Nelder-Mead, hM3's L-BFGS-B tap
optimization and the GMSK TX pulse).  The tests compare every output with
the JAX package's bit for bit.  Importing the JAX package would import
jax, which the port never does.
"""
from __future__ import annotations

from functools import lru_cache as _lru_cache

import numpy as np

__all__ = ["kaiser_beta", "kaiser_window", "firdes_kaiser", "firdes_prototype", "rrcos",
           "halfband_kaiser", "pfb_channelizer_prototype", "gaussian_pulse",
           "PULSE_TYPES"]


def kaiser_beta(As: float) -> float:
    """Kaiser window beta for a target stopband attenuation ``As`` dB."""
    As = abs(As)
    if As > 50.0:
        return 0.1102 * (As - 8.7)
    if As > 21.0:
        return 0.5842 * (As - 21.0) ** 0.4 + 0.07886 * (As - 21.0)
    return 0.0


def kaiser_window(n: int, beta: float) -> np.ndarray:
    return np.kaiser(n, beta)


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


def _root_nyquist_from_spectrum(k: int, m: int, beta: float,
                                shape_fn) -> np.ndarray:
    """Root-Nyquist pulse from a |H(f)|^2 Nyquist spectrum ``shape_fn(f)``.

    ``shape_fn`` maps normalized frequency (cycles/symbol) to the Nyquist
    amplitude spectrum in [0, 1]; the root pulse is the inverse DFT of its
    square root, windowed to ``2*k*m+1`` taps.
    """
    n = 2 * k * m + 1
    nfft = 4096
    f = np.fft.fftfreq(nfft) * k  # cycles per symbol
    H = np.sqrt(np.maximum(shape_fn(np.abs(f), beta), 0.0))
    h = np.real(np.fft.ifft(H))
    h = np.roll(h, (n - 1) // 2)[:n]
    h *= np.kaiser(n, 4.0)
    return h / np.sqrt(np.sum(h ** 2))


def _nyq_rcos(fa, beta):
    out = np.zeros_like(fa)
    f1, f2 = (1 - beta) / 2.0, (1 + beta) / 2.0
    out[fa <= f1] = 1.0
    mid = (fa > f1) & (fa < f2)
    if beta > 0:
        out[mid] = 0.5 * (1 + np.cos(np.pi / beta * (fa[mid] - f1)))
    return out


def _nyq_fexp(fa, beta):
    """Flipped exponential Nyquist spectrum (Beaulieu et al.)."""
    out = np.zeros_like(fa)
    f1, f2 = (1 - beta) / 2.0, (1 + beta) / 2.0
    B = np.log(2.0) / (beta / 2.0) if beta > 0 else 1.0
    out[fa <= f1] = 1.0
    lo = (fa > f1) & (fa <= 0.5)
    out[lo] = np.exp(B * (f1 - fa[lo]))
    hi = (fa > 0.5) & (fa < f2)
    out[hi] = 1.0 - np.exp(B * (fa[hi] - f2))
    return out


def _nyq_fsech(fa, beta):
    out = np.zeros_like(fa)
    f1, f2 = (1 - beta) / 2.0, (1 + beta) / 2.0
    g = np.log(np.sqrt(3) + 2) / (beta / 2.0) if beta > 0 else 1.0
    out[fa <= f1] = 1.0
    lo = (fa > f1) & (fa <= 0.5)
    out[lo] = 1.0 / np.cosh(g * (fa[lo] - f1))
    hi = (fa > 0.5) & (fa < f2)
    out[hi] = 1.0 - 1.0 / np.cosh(g * (f2 - fa[hi]))
    return out


def _nyq_farcsech(fa, beta):
    """Flipped-arcsech Nyquist spectrum — the functional flip of fsech:
    ``H(f1+d) + H(f2-d) = 1`` with the arcsech transition measured from
    the OPPOSITE band edge, normalized so H(0.5) = 1/2 exactly
    (``asech(1/2) = log(2+sqrt(3))``).  Continuous and monotone across
    the whole transition band."""
    out = np.zeros_like(fa)
    f1, f2 = (1 - beta) / 2.0, (1 + beta) / 2.0

    def asech(x):
        x = np.clip(x, 1e-12, 1.0)
        return np.log((1 + np.sqrt(1 - x ** 2)) / x)

    A2 = 2.0 * np.log(2.0 + np.sqrt(3.0))        # 2 asech(1/2)
    out[fa <= f1] = 1.0
    lo = (fa > f1) & (fa <= 0.5)
    out[lo] = 1.0 - asech((f2 - fa[lo]) / max(beta, 1e-12)) / A2
    hi = (fa > 0.5) & (fa < f2)
    out[hi] = asech((fa[hi] - f1) / max(beta, 1e-12)) / A2
    return out


def _gmsk_tx(k: int, m: int, bt: float) -> np.ndarray:
    """GMSK transmit 'matched' pulse: gaussian convolved with a symbol rect."""
    g = gaussian_pulse(k, m, bt)
    rect = np.ones(k) / k
    h = np.convolve(g, rect)
    n = 2 * k * m + 1
    c = (len(h) - n) // 2
    h = h[c:c + n] if c >= 0 else np.pad(h, (-c, n - len(h) + c))
    return h / np.sqrt(np.sum(h ** 2))


PULSE_TYPES = ("rrcos", "rkaiser", "arkaiser", "hm3", "gmsktx",
               "fexp", "fsech", "farcsech")


def matched_isi_db(h: np.ndarray, k: int) -> float:
    """ISI power (dB) of the matched cascade ``h * h~`` at the symbol
    lattice (the figure of merit the root-Nyquist designs minimize)."""
    g = np.convolve(h, h[::-1])
    c = len(g) // 2
    g = g / g[c]
    lat = np.concatenate([g[c + k::k], g[c - k::-k]])
    return float(10.0 * np.log10(np.sum(lat ** 2) + 1e-30))


def stopband_atten_db(h: np.ndarray, k: int, beta: float,
                      nfft: int = 8192) -> float:
    """Worst-case attenuation (dB) beyond the excess-bandwidth edge
    ``(1+beta)/2`` cycles/symbol."""
    H = np.abs(np.fft.rfft(h / np.sum(h), nfft))
    f = np.fft.rfftfreq(nfft) * k       # cycles/symbol
    sb = H[f > (1 + beta) / 2.0 * 1.05]
    if not sb.size:
        # the stopband edge sits beyond Nyquist (k=1, or k=2 with very
        # large beta): there is no stopband to violate
        return float("inf")
    return float(-20.0 * np.log10(np.max(sb) + 1e-30))


def _rkaiser_candidate(k: int, m: int, beta: float, rho: float,
                       bw: float) -> np.ndarray:
    n = 2 * k * m + 1
    fc = 0.5 * (1.0 + beta * (2.0 * rho - 1.0)) / k
    t = np.arange(n) - (n - 1) / 2.0
    h = 2 * fc * np.sinc(2 * fc * t) * np.kaiser(n, bw)
    return h / np.sqrt(np.sum(h ** 2))


def _rkaiser_objective(k: int, m: int, beta: float, rho: float,
                       bw: float) -> float:
    """ISI of the matched cascade + a soft stopband-violation penalty."""
    h = _rkaiser_candidate(k, m, beta, rho, bw)
    isi = matched_isi_db(h, k)
    atten = stopband_atten_db(h, k, beta)
    return isi + 4.0 * max(0.0, 50.0 - atten)


def _rkaiser_design(k: int, m: int, beta: float,
                    refine: bool) -> np.ndarray:
    """Root-Nyquist Kaiser pulse: ISI-minimizing (cutoff, window) search.

    The design principle of liquid's rkaiser (a Kaiser-windowed sinc whose
    bandwidth factor is tuned so the matched cascade is Nyquist) implemented
    as a direct numerical search: coarse grid over the cutoff factor
    ``rho`` and window shape, then (for the exact variant) Nelder-Mead
    refinement.  ``refine=False`` is the ARKaiser fast approximation.
    """
    best = (np.inf, 0.5, 6.0)
    for rho in np.linspace(0.05, 0.95, 13):
        for bw in np.linspace(2.0, 12.0, 11):
            v = _rkaiser_objective(k, m, beta, rho, bw)
            if v < best[0]:
                best = (v, rho, bw)
    # local refinement grid (cheap; this alone is the ARKaiser approximation)
    r0, b0 = best[1], best[2]
    for rho in np.linspace(r0 - 0.07, r0 + 0.07, 9):
        for bw in np.linspace(max(0.5, b0 - 1.0), b0 + 1.0, 9):
            v = _rkaiser_objective(k, m, beta, rho, bw)
            if v < best[0]:
                best = (v, rho, bw)
    rho, bw = best[1], best[2]
    if refine:
        from scipy.optimize import minimize
        r = minimize(lambda x: _rkaiser_objective(k, m, beta, x[0], x[1]),
                     [rho, bw], method="Nelder-Mead",
                     options={"xatol": 1e-5, "fatol": 1e-9, "maxiter": 400})
        rho, bw = float(r.x[0]), float(r.x[1])
    return _rkaiser_candidate(k, m, beta, rho, bw)


def _hm3_design(k: int, m: int, beta: float) -> np.ndarray:
    """harris-Moerder-style direct root-Nyquist optimization.

    Optimizes the taps themselves: minimize stopband energy beyond the
    ``(1+beta)/2`` excess-bandwidth edge subject to the matched cascade
    being Nyquist (ISI -> 0), via penalized BFGS from an RRC start — the
    'design the root filter numerically, not from a closed form' approach
    of harris & Moerder.  Beats windowed closed forms on ISI at equal
    stopband.
    """
    from scipy.optimize import minimize
    n = 2 * k * m + 1
    nfft = 2048
    f = np.fft.rfftfreq(nfft) * k
    sb_mask = f > (1 + beta) / 2.0
    h0 = rrcos(k, m, beta)

    def obj(h):
        g = np.convolve(h, h[::-1])
        c = len(g) // 2
        lat = np.concatenate([g[c + k::k], g[c - k::-k]])
        isi = np.sum(lat ** 2)
        nyq = (g[c] - 1.0) ** 2
        H = np.abs(np.fft.rfft(h, nfft))
        sb = np.sum(H[sb_mask] ** 2) / nfft
        # weights picked so the k=2,m=9,beta=0.2 design point dominates the
        # truncated RRC on BOTH axes (ISI -66 dB / stopband 50 dB vs RRC's
        # -50 / 36)
        return 1e4 * isi + 1e4 * nyq + 3e3 * sb

    r = minimize(obj, h0, method="L-BFGS-B",
                 options={"maxiter": 800, "ftol": 1e-15})
    h = r.x
    return h / np.sqrt(np.sum(h ** 2))


@_lru_cache(maxsize=None)
def _pulse_cached(ftype: str, k: int, m: int, beta: float) -> np.ndarray:
    if ftype == "rkaiser":
        return _rkaiser_design(k, m, beta, refine=True)
    if ftype == "arkaiser":
        return _rkaiser_design(k, m, beta, refine=False)
    if ftype == "hm3":
        return _hm3_design(k, m, beta)
    raise ValueError(ftype)


def firdes_prototype(ftype: str, k: int, m: int, beta: float) -> np.ndarray:
    """Matched-filter pulse prototype by name (the ``narrowband_tx -t`` set,
    the reference's src/narrowband_tx.cc:90-101). ``2*k*m+1`` taps."""
    ftype = ftype.lower()
    if ftype in ("rrcos", "rrc"):
        return rrcos(k, m, beta)
    if ftype in ("rkaiser", "arkaiser", "hm3"):
        return _pulse_cached(ftype, k, m, float(beta))
    if ftype == "gmsktx":
        return _gmsk_tx(k, m, max(beta, 0.1))
    if ftype == "fexp":
        return _root_nyquist_from_spectrum(k, m, beta, _nyq_fexp)
    if ftype == "fsech":
        return _root_nyquist_from_spectrum(k, m, beta, _nyq_fsech)
    if ftype == "farcsech":
        return _root_nyquist_from_spectrum(k, m, beta, _nyq_farcsech)
    raise ValueError(f"unknown pulse type '{ftype}'; one of {PULSE_TYPES}")


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
