"""Blocking host waits (``profiling.SYNC_CALLS``) that start inside the
program's ``rx.codec`` spans, over the window's dispatches: the payload
codec's host reads (the demap table gate, the FEC stages' scheme ids) and
synchronous uploads."""
from ..profiling import SYNC_CALLS
from ..spans import spans


def read(trace, cell):
    codec = spans(trace, "rx.codec")
    if not codec:
        return None
    waits = sum(any(s.start <= o.start < s.end for s in codec)
                for o in trace.host if o.name in SYNC_CALLS)
    return waits / trace.dispatches
