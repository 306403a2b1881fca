"""Megabytes a dispatch that rank 0's collectives sent to other ranks: the
program's ``exchange_bytes`` counter (``parallel/_comm.py``, counted on
the host from the tensors' sizes), counted while the window was traced."""
from ..spans import counter


def read(trace, cell):
    n = counter("exchange_bytes")
    return None if n is None else n / 1e6 / trace.dispatches
