"""Wall-clock tic/toc timer (the reference's C timer API).

Port of ``liquid_usrp_tpu/utils/timer.py``.  Host wall time: a caller that
times work on the card synchronises first (``torch.cuda.synchronize()``).
"""
from __future__ import annotations

import time

__all__ = ["Timer", "timer_create"]


class Timer:
    def __init__(self):
        self._t0 = time.time()

    def tic(self):
        self._t0 = time.time()

    def toc(self) -> float:
        """Elapsed seconds since the last tic (float, like timer_toc)."""
        return time.time() - self._t0


def timer_create() -> Timer:
    return Timer()
