"""Streaming spectrogram and its ASCII rendering (asgram semantics).

Port of ``liquid_usrp_tpu/ops/spectrum.py``: every length-``nfft`` frame of
a block is windowed and transformed at once (``[n_frames, nfft]``, cuFFT
on the card), the dB spectra are DC-centred and the ASCII quantization is
a host-side formatting step over the returned rows.  The window is
``np.hamming`` (the symmetric form), as in JAX; ``torch.hamming_window``
defaults to the periodic form and differs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.consts import on

__all__ = ["Spectrogram", "spectrogram_create", "spectrogram_block",
           "ascii_row"]


class Spectrogram(NamedTuple):
    nfft: int
    window: np.ndarray       # [nfft] float32 (NumPy; moved per device)
    ref_level: float         # dB offset
    scale: float             # dB per character


def spectrogram_create(nfft: int = 64, ref_level: float = -65.0,
                       scale: float = 5.0) -> Spectrogram:
    return Spectrogram(nfft=nfft, window=np.hamming(nfft).astype(np.float32),
                       ref_level=ref_level, scale=scale)


def spectrogram_block(sg: Spectrogram, x: torch.Tensor):
    """dB spectra of every length-``nfft`` frame of ``x [n_frames * nfft]``
    -> ``psd_db [n_frames, nfft]`` (DC-centred), ``peak_db [n_frames]`` and
    ``peak_freq [n_frames]`` in cycles/sample in [-0.5, 0.5) (the first
    maximum of each row)."""
    nfft = sg.nfft
    frames = x.reshape(-1, nfft) * on(sg.window, x.device).to(x.dtype)
    spec = torch.fft.fftshift(torch.fft.fft(frames, dim=-1), dim=-1)
    psd = 20.0 * torch.log10(torch.clamp(torch.abs(spec), min=1e-12) /
                             float(np.sqrt(nfft)))
    peak_idx = torch.argmax(psd, dim=-1)
    peak_db = torch.gather(psd, -1, peak_idx[:, None])[:, 0]
    peak_freq = (peak_idx.to(torch.float32) - nfft // 2) / nfft
    return psd, peak_db, peak_freq


_ASCII_RAMP = " ._-+o*&$#"


def ascii_row(sg: Spectrogram, psd_db_row) -> str:
    """Render one PSD row (host array) to the ASCII waterfall format."""
    q = (np.asarray(psd_db_row) - sg.ref_level) / sg.scale
    q = np.clip(q.astype(np.int64), 0, len(_ASCII_RAMP) - 1)
    return "".join(_ASCII_RAMP[i] for i in q)
