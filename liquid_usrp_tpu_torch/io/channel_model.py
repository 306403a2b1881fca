"""Synthetic channel impairments for loopback testing.

Port of ``liquid_usrp_tpu/io/channel_model.py``: gain, sample-rate offset,
multipath, integer delay, carrier frequency offset and phase, and AWGN at an
exact SNR, applied to a complex64 stream on its own device.  The noise
comes from an explicit ``torch.Generator`` (on the stream's device), so a
run is reproducible from its seed; it cannot reproduce JAX's PRNG bits, so
the noise matches JAX in distribution, not sample for sample.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import resamp as resamp_mod

__all__ = ["Channel", "channel_apply", "awgn", "snr_to_noise_std"]


class Channel(NamedTuple):
    snr_db: float = 100.0        # AWGN SNR relative to unit signal power
    cfo: float = 0.0             # carrier offset, radians/sample
    phase: float = 0.0           # static phase, radians
    delay: int = 0               # integer sample delay (prepended zeros)
    gain: float = 1.0            # linear amplitude gain
    multipath: Optional[tuple] = None  # complex tap tuple, tap0 = LOS
    sro_ppm: float = 0.0         # sample-rate offset (clock skew), ppm


def snr_to_noise_std(snr_db: float, signal_power: float = 1.0) -> float:
    return float((signal_power * 10.0 ** (-snr_db / 10.0)) ** 0.5)


def awgn(generator: torch.Generator, x: torch.Tensor, snr_db: float,
         signal_power: float = 1.0) -> torch.Tensor:
    """``x`` plus complex Gaussian noise of total power ``signal_power *
    10^(-snr_db/10)``, drawn from ``generator``."""
    std = snr_to_noise_std(snr_db, signal_power)
    noise = torch.randn((2,) + tuple(x.shape), generator=generator,
                        dtype=torch.float32, device=x.device)
    return x + torch.complex(noise[0], noise[1]) * (std / 2.0 ** 0.5)


def channel_apply(ch: Channel, generator: torch.Generator, x: torch.Tensor,
                  signal_power: float = 1.0) -> torch.Tensor:
    """Apply gain -> sample-rate offset -> multipath -> delay -> CFO/phase
    -> AWGN to a stream."""
    y = x.to(torch.complex64) * ch.gain
    if ch.sro_ppm != 0.0:
        # max_den bounded so resamp_block's int32 timing stays safe (its
        # guard trips past about 65k samples, as in JAX); the rate rounding
        # is far below the ppm-scale effect being modeled.  The trailing
        # invalid slots are zeros.
        rs = resamp_mod.resamp_create(1.0 + ch.sro_ppm * 1e-6,
                                      max_den=1 << 15)
        _, y, _, _ = resamp_mod.resamp_block(
            rs, resamp_mod.resamp_state(rs, y.device), y)
    if ch.multipath is not None:
        # jnp.convolve(y, taps, "full")[:n]: tap k delays y by k samples
        taps = torch.tensor(ch.multipath, dtype=torch.complex64)
        n = y.shape[-1]
        acc = y * taps[0].to(y.device)
        for k in range(1, len(taps)):
            acc[k:] += y[:n - k] * taps[k].to(y.device)
        y = acc
    if ch.delay:
        y = torch.nn.functional.pad(y, (ch.delay, 0))
    if ch.cfo != 0.0 or ch.phase != 0.0:
        n = torch.arange(y.shape[-1], dtype=torch.float32, device=y.device)
        arg = ch.phase + ch.cfo * n
        y = y * torch.polar(torch.ones_like(arg), arg)
    if ch.snr_db < 100.0:
        y = awgn(generator, y, ch.snr_db, signal_power * float(ch.gain) ** 2)
    return y
