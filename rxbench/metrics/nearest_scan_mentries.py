"""(point, table entry) pairs the nearest-point scans compared, in
millions a dispatch: the program's ``nearest_entries`` counter
(``payload._nearest_sym`` and ``generic_demod_soft``: the
decision-directed pass, the demap and the payload EVM), counted while the
window was traced."""
from ..spans import counter


def read(trace, cell):
    n = counter("nearest_entries")
    return None if n is None else n / 1e6 / trace.dispatches
