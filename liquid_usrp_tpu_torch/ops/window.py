"""Fixed-size sliding sample logs (windowcf/windowf semantics).

Port of ``liquid_usrp_tpu/ops/window.py``: a ring log as a NamedTuple of
tensors; a block ``push`` is a roll and a slice assignment, and ``read``
returns the time-ordered view.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import default_device

__all__ = ["RingLog", "ring_init", "ring_push", "ring_read", "ring_valid"]


class RingLog(NamedTuple):
    buf: torch.Tensor     # [capacity]
    count: torch.Tensor   # int32: valid samples, saturated at capacity


def ring_init(capacity: int, dtype=torch.complex64, device=None) -> RingLog:
    dev = default_device(device)
    return RingLog(buf=torch.zeros(capacity, dtype=dtype, device=dev),
                   count=torch.tensor(0, dtype=torch.int32, device=dev))


def ring_push(ring: RingLog, x: torch.Tensor) -> RingLog:
    """Append a block (keeps the newest ``capacity`` samples).  The count
    saturates at the capacity, so it never wraps on a long stream."""
    cap = ring.buf.shape[0]
    n = x.shape[-1]
    new_count = torch.clamp(ring.count + n, max=cap).to(torch.int32)
    x = x.to(ring.buf.dtype)
    if n >= cap:
        return RingLog(buf=x[n - cap:].clone(), count=new_count)
    buf = torch.roll(ring.buf, -n)
    buf[cap - n:] = x
    return RingLog(buf=buf, count=new_count)


def ring_read(ring: RingLog) -> torch.Tensor:
    """Time-ordered contents (oldest first; zeros before the first wrap —
    the valid suffix has :func:`ring_valid` samples)."""
    return ring.buf


def ring_valid(ring: RingLog) -> torch.Tensor:
    """Number of valid samples in the view (<= capacity)."""
    return ring.count
