"""Device mesh construction for the SDR pipelines.

Port of ``liquid_usrp_tpu/parallel/mesh.py`` onto ``torch.distributed``.
The scaling axes are the JAX package's:

* ``time``    — stream time blocks with an overlap-save halo exchange,
* ``channel`` — the per-channel synchronizers of the multichannel
  receiver.

One process (rank) drives one device, so the mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
process group, laid out row-major as ``jax.make_mesh`` lays out devices:
rank ``r`` sits at ``(r // c, r % c)``.  The sharded builders of
:mod:`.stream` read ``mesh.get_local_rank(dim)`` and ``mesh.get_group(dim)``
where JAX reads ``lax.axis_index`` and the mesh axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_sdr_mesh", "factor_devices"]


def factor_devices(n: int) -> tuple[int, int]:
    """Split ``n`` devices into (time, channel) axes, preferring balance."""
    best = (n, 1)
    for t in range(1, n + 1):
        if n % t == 0:
            c = n // t
            if abs(t - c) < abs(best[0] - best[1]):
                best = (t, c)
    return best


def make_sdr_mesh(n_devices: int | None = None,
                  axis_shapes: tuple[int, int] | None = None) -> DeviceMesh:
    """Mesh with named dims ``('time', 'channel')`` over ranks
    ``0..n_devices-1`` of the initialized process group (all of it by
    default).  Every rank of the group calls this, as it creates the dims'
    groups.  The mesh's device type follows the backend: ``"cuda"`` under
    NCCL, else ``"cpu"`` (ranks that share a card talk through host
    memory)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed."
                           "init() (or spawn a world) first")
    world = dist.get_world_size()
    n = n_devices if n_devices is not None else world
    if n > world:
        raise ValueError(f"requested {n} devices but only {world} available")
    t, c = axis_shapes if axis_shapes is not None else factor_devices(n)
    if t * c != n:
        raise ValueError(f"axis shapes {t}x{c} != {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(t, c),
                      mesh_dim_names=("time", "channel"))
