"""Virtual air: connects transceiver endpoints through a derived channel.

Port of ``liquid_usrp_tpu/io/radio.py``.  The channel between two endpoints
follows from their ``RadioConfig``s: a carrier mismatch becomes a frequency
offset in radians/sample at the RX rate (plus an optional reference
oscillator error), with AWGN at the link SNR.  Mistune one radio and the
synchronizer must recover the offset, as over the air.  The noise comes
from a CPU ``torch.Generator`` seeded from ``seed`` and the use count.
"""
from __future__ import annotations

import numpy as np
import torch

from .channel_model import Channel, channel_apply

__all__ = ["VirtualAir"]


class VirtualAir:
    """Impairment channel between two transceiver endpoints."""

    def __init__(self, snr_db: float = 40.0, delay: int = 0, seed: int = 0):
        self.snr_db = snr_db
        self.delay = delay
        self._seed = seed
        self._uses = 0

    def propagate(self, tx_radio, rx_radio, samples: np.ndarray,
                  ppm_error: float = 0.0) -> np.ndarray:
        """Carry host ``samples`` from a TX front end (``tx_freq``) to an RX
        front end (``rx_freq``, ``rx_rate``); ``ppm_error`` adds a reference
        oscillator offset in ppm of the carrier."""
        f_err = (tx_radio.tx_freq - rx_radio.rx_freq +
                 tx_radio.tx_freq * ppm_error * 1e-6)
        cfo = 2.0 * np.pi * f_err / rx_radio.rx_rate
        samples = np.asarray(samples, np.complex64)
        power = (float(np.mean(np.abs(samples) ** 2))
                 if samples.size else 1.0) or 1.0
        ch = Channel(snr_db=self.snr_db, cfo=float(cfo), delay=self.delay)
        self._uses += 1
        gen = torch.Generator().manual_seed(self._seed + self._uses)
        return channel_apply(ch, gen, torch.as_tensor(samples),
                             signal_power=power).numpy()
