"""Host time a dispatch in the program's ``rx.exchange`` spans, their own:
every collective of the sharded receiver (``parallel/_comm.py``: the
analysis and sync halos' ``ppermute``\\ s, the all-to-all's launch and its
wait, the results' gather onto rank 0), on rank 0."""
from ..spans import self_ms_per_dispatch


def read(trace, cell):
    return self_ms_per_dispatch(trace, "rx.exchange")
