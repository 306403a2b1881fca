"""Tracing and throughput counters.

Port of ``liquid_usrp_tpu/utils/profiling.py``:

* :func:`trace` -- a context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``,
  and the counts :func:`count` made meanwhile beside it; it records the
  card's kernels too when CUDA is there;
* :func:`span` and :func:`count` -- the receive path's spans and counters,
  recorded only while a torch profiler records;
* :class:`ThroughputMeter` -- per-block samples/s with an EMA and lifetime
  totals, on the host's wall clock.

Tracing is on while a ``torch.profiler`` records (``trace``, or any other
profiler): a span is then a host ``cpu_op`` event of the profile, on the
clock the profiler stamps the card's kernels with, and a count adds to
:data:`counters`.  With no profiler, :func:`span` hands back one shared
no-op context manager and :func:`count` returns at once.  Neither ever
touches the card: no CUDA event, no synchronize, no host read; a count is
made from what the host already holds.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = ["trace", "span", "count", "counters", "ThroughputMeter"]

# name -> total, added to only while a profiler records
counters: dict = {}
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager recording ``name`` over the enclosed block as a
    host ``cpu_op`` range while a profiler records (the span that encloses
    it on the same thread is its parent); a shared no-op otherwise.  A
    ``cpu_op``, unlike ``record_function``'s ``user_annotation``, has no
    mirror on the card's timeline."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return _OFF


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to ``counters[name]`` while a profiler
    records."""
    if torch.autograd._profiler_enabled():
        counters[name] = counters.get(name, 0) + n


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; on exit write ``log_dir/trace.json`` and
    ``log_dir/counters.json`` (what each counter added in the block).
    Yields the ``torch.profiler.profile`` object (``key_averages()``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = dict(counters)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump({k: v - before.get(k, 0) for k, v in counters.items()},
                  f, indent=1)


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
