"""Device idle share of the traced window: 100 x (1 - the union of the
device's operations (kernels, copies, sets) over the window's wall time)."""
from ..profiling import busy_seconds


def read(trace, cell):
    if not trace.device:
        return None
    return 100.0 * (1.0 - busy_seconds(trace) / trace.seconds)
