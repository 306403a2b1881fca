"""Host time a dispatch in the program's ``rx.front_end`` span, its own:
``Mcrx.front_end``, the NCO mix-down and the PFB analyzer."""
from ..spans import self_ms_per_dispatch


def read(trace, cell):
    return self_ms_per_dispatch(trace, "rx.front_end")
