"""Tracing and throughput counters.

Port of ``liquid_usrp_tpu/utils/profiling.py``:

* :func:`trace` -- a context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``;
  it records the card's kernels too when CUDA is there;
* :class:`ThroughputMeter` -- per-block samples/s with an EMA and lifetime
  totals, on the host's wall clock.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "ThroughputMeter"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; on exit write ``log_dir/trace.json``.
    Yields the ``torch.profiler.profile`` object (``key_averages()``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ThroughputMeter:
    """Samples/s counter over streamed blocks (EMA + lifetime totals).

    Host wall time between :meth:`start` and :meth:`stop`.  Work launched
    on the card returns before it is done, so a caller timing device work
    synchronises (``torch.cuda.synchronize()``) before :meth:`stop`."""

    def __init__(self, ema_alpha: float = 0.2):
        self.alpha = ema_alpha
        self.total_samples = 0
        self.total_time = 0.0
        self.ema_sps = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_samples: int):
        if self._t0 is None:
            raise RuntimeError("ThroughputMeter.stop() without start()")
        dt = time.perf_counter() - self._t0
        self.total_samples += n_samples
        self.total_time += dt
        sps = n_samples / max(dt, 1e-12)
        self.ema_sps = (sps if self.ema_sps == 0.0 else
                        self.alpha * sps + (1 - self.alpha) * self.ema_sps)
        return sps

    @property
    def mean_sps(self) -> float:
        return self.total_samples / max(self.total_time, 1e-12)
