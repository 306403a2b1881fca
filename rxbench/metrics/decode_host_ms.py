"""Host time a dispatch in the program's ``rx.decode`` span less its
``rx.codec``: ``_gated_decode``'s window gather, ``_decode_window`` (CFO,
timing, channel, header, the decision-directed passes) and the EVM."""
from ..spans import self_ms_per_dispatch


def read(trace, cell):
    return self_ms_per_dispatch(trace, "rx.decode")
