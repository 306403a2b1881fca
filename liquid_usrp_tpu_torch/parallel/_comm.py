"""Collectives of the parallel layer over ``torch.distributed``.

Each helper is the counterpart of one ``lax`` collective inside the JAX
package's ``shard_map`` bodies, over the dims of a ``('time', 'channel')``
:class:`~torch.distributed.device_mesh.DeviceMesh`:

* :func:`ppermute` — ``lax.ppermute``: point-to-point sends between the
  ranks of a dim, or of several dims in combined row-major order; a rank
  that no pair sends to gets zeros.
* :func:`all_to_all` — ``lax.all_to_all(..., tiled=False)`` over one dim
  (``all_to_all_single`` on the dim's group), optionally left in flight.
* :func:`gather_tree` — the global view of a result tree that JAX's
  ``out_specs`` assemble: every leaf gathered over the mesh dims, as
  bytes, into host NumPy arrays ``[size(dim0), size(dim1), ..., *leaf]``.
* :func:`gather_first` — the same view on the first rank along the dims
  only, as tensors on its device: under NCCL nothing reaches the host and
  the host waits for nothing.

Complex tensors travel as their float32 pairs.  The backend decides the
staging up front: under gloo a CUDA tensor goes through a pinned host copy
(gloo's point-to-point and all-to-all take host tensors), under NCCL it
stays on the card.

Tracing (``utils/profiling.py``): every call opens one ``rx.exchange``
span (an all-to-all two, its launch and its wait), and counts under
``exchange_bytes`` the bytes this rank sends to other ranks, from the
tensors' sizes on the host: a ``ppermute``'s tensor once a destination,
the other ranks' pieces of an all-to-all, a gather's buffer once a rank
it reaches.  Both only while a profiler records.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils.profiling import count, span

__all__ = ["dim_size", "ppermute", "all_to_all", "gather_tree",
           "gather_first"]
EXCHANGE = "rx.exchange"


def dim_size(mesh, name: str) -> int:
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(name)])


def _axis_ranks(mesh, dims: tuple) -> tuple[list[int], int]:
    """Global ranks along ``dims`` (combined row-major in the order given)
    through this rank's coordinates on the other dims, and this rank's
    index among them."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
    sub = mesh.mesh[tuple(slice(None) if n in dims else coord[k]
                          for k, n in enumerate(names))]
    kept = [n for n in names if n in dims]
    ranks = sub.permute([kept.index(d) for d in dims]).reshape(-1).tolist()
    return ranks, ranks.index(dist.get_rank())


def _host_staged(x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend() == "gloo"


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the backend takes it: real, contiguous, and on the host
    (pinned) when gloo must carry a card's tensor."""
    w = torch.view_as_real(x) if x.is_complex() else x
    w = w.contiguous()
    if _host_staged(w):
        h = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
        h.copy_(w)
        return h
    return w


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    w = w.to(like.device)
    return torch.view_as_complex(w) if like.is_complex() else w


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def ppermute(x: torch.Tensor, mesh, dims, pairs) -> torch.Tensor:
    """``lax.ppermute(x, dims, pairs)``: index ``s`` along ``dims`` sends
    ``x`` to index ``d`` for each ``(s, d)`` in ``pairs``; an index that no
    pair targets gets zeros.  Every rank of the mesh calls it."""
    dims = (dims,) if isinstance(dims, str) else tuple(dims)
    ranks, me = _axis_ranks(mesh, dims)
    src = [s for s, d in pairs if d == me]
    dst = [d for s, d in pairs if s == me]
    if me in src and me in dst:              # a pair from a rank to itself
        return x.clone()
    with span(EXCHANGE):
        send = _wire(x)
        count("exchange_bytes", _nbytes(send) * len(dst))
        recv = torch.zeros_like(send) if src else None
        ops = [dist.P2POp(dist.isend, send, ranks[d]) for d in dst]
        ops += [dist.P2POp(dist.irecv, recv, ranks[s]) for s in src]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        out = _unwire(recv, x) if src else torch.zeros_like(x)
    return out


class _Pending:
    """An all-to-all in flight: :meth:`wait` gives its result."""

    def __init__(self, work, recv, like, concat_axis):
        self._work, self._recv, self._like = work, recv, like
        self._axis = concat_axis

    def wait(self) -> torch.Tensor:
        with span(EXCHANGE):
            self._work.wait()
            return _unwire(self._recv, self._like).movedim(0, self._axis)


def all_to_all(x: torch.Tensor, mesh, dim: str, split_axis: int,
               concat_axis: int, async_op: bool = False):
    """``lax.all_to_all(x, dim, split_axis, concat_axis, tiled=False)``:
    ``x.shape[split_axis]`` equals the dim's size; piece ``j`` of the split
    goes to index ``j``, and the pieces received stack in source order on a
    new axis at ``concat_axis`` of the rest.  ``async_op=True`` returns a
    handle whose ``wait()`` gives the result, so work can run while the
    exchange is in flight."""
    n = dim_size(mesh, dim)
    if x.shape[split_axis] != n:
        raise ValueError(f"split axis of size {x.shape[split_axis]}, "
                         f"dim {dim!r} has {n} ranks")
    with span(EXCHANGE):
        like = x.movedim(split_axis, 0)
        send = _wire(like)
        count("exchange_bytes", _nbytes(send) // n * (n - 1))
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send,
                                      group=mesh.get_group(dim),
                                      async_op=True)
        pending = _Pending(work, recv, like, concat_axis)
    return pending if async_op else pending.wait()


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _pack(leaves) -> torch.Tensor:
    """The leaves' bytes, one after another, as one uint8 tensor."""
    return torch.cat([v.contiguous().reshape(-1).view(torch.uint8)
                      for v in leaves])


def gather_tree(leaves, mesh, dims) -> list[np.ndarray]:
    """Every rank's ``leaves`` (a sequence of tensors, e.g. a result
    NamedTuple) on every rank, as NumPy arrays ``[size(dims[0]), ...,
    size(dims[-1]), *leaf.shape]``: the leaves travel packed as one byte
    buffer, gathered over the last dim first, so any dtype (bool, uint8,
    int32, float32, complex64) crosses either backend unchanged."""
    dims = (dims,) if isinstance(dims, str) else tuple(dims)
    leaves = list(leaves)
    with span(EXCHANGE):
        buf = _pack(leaves)
        wire = _wire(buf)
        # the buffer reaches every other rank along the dims once
        count("exchange_bytes", _nbytes(wire) * (int(np.prod(
            [dim_size(mesh, d) for d in dims])) - 1))
        for d in reversed(dims):
            parts = [torch.empty_like(wire) for _ in range(dim_size(mesh, d))]
            dist.all_gather(parts, wire, group=mesh.get_group(d))
            wire = torch.stack(parts)
        host = wire.cpu().numpy()
    lead = host.shape[:-1]
    out, off = [], 0
    for v in leaves:
        nb = _nbytes(v)
        raw = np.ascontiguousarray(host[..., off:off + nb])
        out.append(raw.view(_np_dtype(v.dtype)).reshape(lead + v.shape))
        off += nb
    return out


def gather_first(leaves, mesh, dims) -> list[torch.Tensor] | None:
    """Every rank's ``leaves`` on the rank at index 0 of every dim in
    ``dims``, as tensors on its device ``[size(dims[0]), ...,
    size(dims[-1]), *leaf.shape]``; ``None`` on every other rank.  Packed
    as :func:`gather_tree` packs them and gathered over the last dim
    first, so only the ranks at index 0 of a dim take part in the next.
    Under NCCL the gathers are enqueued on the card and the leaves are
    cut out of the gathered bytes there: nothing is copied to the host or
    waited for (under gloo a card's bytes go through the host)."""
    dims = (dims,) if isinstance(dims, str) else tuple(dims)
    leaves = list(leaves)
    with span(EXCHANGE):
        buf = _pack(leaves)
        wire, sent = _wire(buf), 0
        for d in reversed(dims):
            ranks, me = _axis_ranks(mesh, (d,))
            if me:                   # this rank's part ends here
                dist.gather(wire, None, dst=ranks[0],
                            group=mesh.get_group(d))
                sent, wire = _nbytes(wire), None
                break
            parts = [torch.empty_like(wire) for _ in ranks]
            dist.gather(wire, parts, dst=ranks[0], group=mesh.get_group(d))
            wire = torch.stack(parts)
        count("exchange_bytes", sent)
        if wire is not None:
            wire = _unwire(wire, buf)
    if wire is None:
        return None
    lead = wire.shape[:-1]
    out, off = [], 0
    for v in leaves:
        nb = _nbytes(v)
        # a copy of its own, so that the bytes view as the leaf's dtype
        raw = wire[..., off:off + nb].contiguous()
        out.append(raw.view(v.dtype).reshape(lead + v.shape))
        off += nb
    return out
