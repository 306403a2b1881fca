"""Device kernels the traced window recorded, over its dispatches."""
from ..profiling import is_kernel


def read(trace, cell):
    n = sum(1 for o in trace.device if is_kernel(o.name))
    return n / trace.dispatches if n else None
