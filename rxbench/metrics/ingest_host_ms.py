"""Host time a dispatch in the program's ``rx.ingest`` spans, their own:
staging each chunk for the card (``run_pipelined``'s ``stage()``: the
pinned copy and the upload; ``OfdmTxRx._to_device``)."""
from ..spans import self_ms_per_dispatch


def read(trace, cell):
    return self_ms_per_dispatch(trace, "rx.ingest")
