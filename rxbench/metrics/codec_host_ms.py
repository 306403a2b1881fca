"""Host time a dispatch in the program's ``rx.codec`` span: the payload
codec (demap, FEC with the Viterbi, CRC) and its host reads."""
from ..spans import self_ms_per_dispatch


def read(trace, cell):
    return self_ms_per_dispatch(trace, "rx.codec")
