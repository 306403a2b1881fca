"""The program's spans in a traced window: its ``rx.*`` host ranges
(``liquid_usrp_tpu_torch/utils/profiling.py::span``), which the profiler
records as ``cpu_op`` events on the clock of the card's operations, and
the counters the program keeps beside them.

A span's self time is its duration less the union of the ``rx.*`` spans
inside it.  Readers divide by the window's dispatches and return ``None``
where the window holds no such span or counter (a program without them).
"""
from __future__ import annotations

from liquid_usrp_tpu_torch.utils import profiling as program

from .profiling import union

PREFIX = "rx."


def spans(trace, name: str) -> list:
    """The host ops named ``name``, in order of start."""
    return sorted((o for o in trace.host if o.name == name),
                  key=lambda o: o.start)


def self_us(trace, name: str):
    """Summed self time of the spans named ``name`` (microseconds), or
    ``None`` where there are none."""
    outer = spans(trace, name)
    if not outer:
        return None
    inner = [o for o in trace.host if o.name.startswith(PREFIX)]
    total = 0.0
    for s in outer:
        inside = union(o for o in inner if o is not s and
                       s.start <= o.start and o.end <= s.end)
        total += (s.end - s.start) - sum(e - b for b, e in inside)
    return total


def self_ms_per_dispatch(trace, name: str):
    us = self_us(trace, name)
    return None if us is None else us * 1e-3 / trace.dispatches


def counter(name: str):
    """The program's counter ``name`` (what it added while a profiler
    recorded, in this process), or ``None``."""
    return getattr(program, "counters", {}).get(name)
