"""Blocking host waits the profiler recorded in the traced window
(``profiling.SYNC_CALLS``: stream, device and event synchronizations and
synchronous copies), over its dispatches.  The sink's one result copy a
dispatch is among them, the same on every tree.  Nothing is read where the
trace holds no CUDA runtime call at all."""
from ..profiling import SYNC_CALLS


def read(trace, cell):
    names = [o.name for o in trace.host]
    if not any(n.startswith("cuda") for n in names):
        return None
    return sum(n in SYNC_CALLS for n in names) / trace.dispatches
