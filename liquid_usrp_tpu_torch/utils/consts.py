"""Device copies of host-built constant tables.

The JAX package embeds its NumPy tables (CRC bases, FEC syndrome tables,
constellations, preambles) as compile-time constants of each jitted step.
PyTorch runs eagerly, so the port uploads each table once per device and
reuses it: :func:`on` caches the device tensor under the identity of the
NumPy array.  Only pass arrays that live for the process (the lru-cached
table builders' results and the ``OfdmParams`` fields); the cache keeps a
reference to each, so its identity stays unique.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["on"]

_CACHE: dict = {}


def on(arr: np.ndarray, device, dtype: torch.dtype | None = None
       ) -> torch.Tensor:
    """``arr`` as a tensor on ``device`` (optionally cast to ``dtype``)."""
    key = (id(arr), str(torch.device(device)), dtype)
    hit = _CACHE.get(key)
    if hit is not None and hit[0] is arr:
        return hit[1]
    t = torch.as_tensor(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(dtype)
    t = t.to(device)
    _CACHE[key] = (arr, t)
    return t
