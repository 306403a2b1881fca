"""Host time a dispatch in the program's ``rx.detect`` span, its own: the
extended windows, the detect metric and candidates, and the decode gate's
host read of the detected mask (its wait included)."""
from ..spans import self_ms_per_dispatch


def read(trace, cell):
    return self_ms_per_dispatch(trace, "rx.detect")
