"""Sharded stream processing: time-block (SP) and channel (TP) parallelism.

Port of ``liquid_usrp_tpu/parallel/stream.py`` onto ``torch.distributed``:

* **Time-block sharding** — the stream is split into contiguous per-rank
  chunks; each rank receives the last ``overlap`` samples of its left
  neighbour (:func:`._comm.ppermute`, zeros for rank 0: the stream start)
  and runs the frame synchronizer on its extended chunk.  Every stream
  offset is detected by exactly one rank, so results equal the sequential
  run.
* **Channel sharding** — the per-channel synchronizers of the multichannel
  receiver are split across the ``channel`` mesh dim; within a rank the
  local channels run as one batch.

**Call contract.**  JAX's ``run(stream)`` takes the global array and
``shard_map`` splits it by the builder's ``in_specs``.  Here every rank of
the mesh calls ``run(x_local)`` with its own shard; :func:`shard_for` cuts
it from a global host array in the layout of JAX's ``in_specs``, which each
``run`` carries as ``run.in_spec``.  ``run`` returns on every rank the
global result JAX returns, as NumPy arrays: leaves ``[N, rows, ...]`` in
JAX's row order for the receivers, ``[n_time * rows, ...]`` for the
time-sharded sync and the mixture ``[2N * T]`` for the transmitter.
``run`` applies the receivers' host regroup itself; ``run.regroup`` is kept
only to mirror JAX's public names (JAX exposes it to callers of
``run.jit_fn``, which the port has not).  The all-to-all receiver is also a
streaming step (:func:`make_sharded_mcrx_a2a_step`, which JAX has not):
state in and out as the one-card steps, the global results on the first
rank's device only.

Each rank computes its global sample indices on the host: its mesh
coordinates are Python ints, where JAX traces ``axis_index`` into uint32
arithmetic.  The NCO phase at an index is exact in uint32 either way
(:func:`..ops.nco.nco_init_at`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..framing import ofdm_sync
from ..models.multichannel import _center_offset
from ..ops import iqfmt
from ..ops import nco as nco_mod
from ..ops import pfb as pfb_mod
from ..utils.consts import on
from ..utils.profiling import span
from . import distributed
from ._comm import all_to_all, dim_size, gather_first, gather_tree, ppermute

__all__ = ["make_time_sharded_sync", "make_sharded_mcrx",
           "make_sharded_mcrx_a2a", "make_sharded_mcrx_a2a_step",
           "ShardedMcrxState", "sharded_mcrx", "make_sharded_mctx",
           "shard_for"]

TIME_CHANNEL = ("time", "channel")


def _sync_ops(sync):
    """``(block_fn, state_cls)`` for any streaming frame synchronizer.

    All four frame families share the ``(tail, base)`` carried-state
    contract and the ``block_fn(sync, state, block) -> (state', results)``
    step shape, so time sharding is family-agnostic.
    """
    if isinstance(sync, ofdm_sync.OfdmSync):
        return ofdm_sync.sync_block, ofdm_sync.OfdmSyncState
    from ..framing import flexframe_sync as ffs
    if isinstance(sync, ffs.FlexSync):
        return ffs.flex_sync_block, ffs.FlexSyncState
    from ..framing import gmskframe as gmskf
    if isinstance(sync, gmskf.GmskSync):
        return gmskf.gmsk_sync_block, gmskf.GmskSyncState
    from ..framing import wlan
    if isinstance(sync, wlan.WlanSync):
        return wlan.wlan_sync_block, wlan.WlanSyncState
    raise TypeError(f"unsupported synchronizer type {type(sync).__name__}")


def shard_for(mesh, x, spec):
    """This rank's block of the global array ``x`` (NumPy or torch) laid
    out by ``spec``, a JAX ``PartitionSpec`` written as a tuple: per leading
    axis ``None`` (whole), a dim name, or a tuple of dim names (the axis
    split over their combined row-major index), e.g. ``("time",)``,
    ``(("time", "channel"),)``, ``(None, ("time", "channel"))`` or
    ``("channel", "time")``.  Axes past ``spec`` stay whole."""
    names = mesh.mesh_dim_names
    coord = dict(zip(names, mesh.get_coordinate()))
    size = dict(zip(names, mesh.mesh.shape))
    index = []
    for axis, entry in enumerate(spec):
        if entry is None:
            index.append(slice(None))
            continue
        dims = (entry,) if isinstance(entry, str) else tuple(entry)
        n, k = 1, 0
        for d in dims:
            n, k = n * int(size[d]), k * int(size[d]) + coord[d]
        length = x.shape[axis]
        if length % n:
            raise ValueError(f"axis {axis} of {length} does not split "
                             f"over {n} ranks of {dims}")
        index.append(slice(k * length // n, (k + 1) * length // n))
    return x[tuple(index)]


def _i32(v: int) -> int:
    """``v`` wrapped to int32, as JAX's int32 index arithmetic wraps."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _local_input(x, dev, n: int) -> torch.Tensor:
    """The rank's shard on its device, checked to hold ``n`` values."""
    x = torch.as_tensor(x, device=dev)
    if x.numel() != n:
        raise ValueError(f"this rank's shard holds {x.numel()} values, the "
                         f"builder expects {n} (see run.in_spec)")
    return x


def _chain(n: int) -> list[tuple[int, int]]:
    """Each index sends to its right neighbour."""
    return [(i, i + 1) for i in range(n - 1)]


def make_time_sharded_sync(mesh, sync, chunk_blocks: int, device=None):
    """Time-sharded synchronizer over the mesh dim ``'time'``.

    ``sync`` may be any frame family's synchronizer (``OfdmSync``,
    ``FlexSync``, ``GmskSync`` or ``WlanSync`` — see :func:`_sync_ops`).
    ``mesh`` has a ``'time'`` dim (JAX takes a 1-D mesh:
    ``init_device_mesh(type, (n,), mesh_dim_names=("time",))``).  Each rank
    calls ``run(x_local)`` with its ``chunk_blocks * block_size`` samples
    (``run.in_spec = ("time",)``) and gets the results of the whole stream,
    leading axis ``n_time * chunk_blocks * max_frames`` (masked rows where
    nothing was detected).  The rank loops the family's ``block_fn`` over
    its blocks, as JAX's ``lax.scan``.  ``device``: as
    :func:`.distributed.local_device`.
    """
    n_time = dim_size(mesh, "time")
    B = sync.block_size * chunk_blocks
    halo = sync.overlap
    if B < halo:
        raise ValueError(
            f"per-device chunk ({B}) must cover the halo ({halo}); "
            "raise chunk_blocks or block_size")
    block_fn, state_cls = _sync_ops(sync)
    dev = distributed.local_device(device)
    t_idx = mesh.get_local_rank("time")
    bs = sync.block_size

    def run(x_local):
        x = _local_input(x_local, dev, B).reshape(-1)
        left = ppermute(x[B - halo:], mesh, "time", _chain(n_time))
        state = state_cls(tail=left, base=torch.tensor(
            _i32(t_idx * B - halo), dtype=torch.int32, device=dev))
        rows = []
        for b in range(chunk_blocks):
            state, res = block_fn(sync, state, x[b * bs:(b + 1) * bs])
            rows.append(res)
        local = [torch.cat(leaf) for leaf in zip(*rows)]
        out = gather_tree(local, mesh, ("time",))
        return type(rows[0])(*(v.reshape((-1,) + v.shape[2:])
                               for v in out))

    run.in_spec = ("time",)
    return run


def _make_regroup(N: int):
    """Host-side result regroup shared by both sharded receivers: leaves
    arrive ``[n_time, n_ch_shards, N_loc, rows, ...]`` from the mesh;
    reorder to ``[N, n_time * rows, ...]``."""
    def fix(v):
        v = np.moveaxis(v, 0, 2)             # [n_ch, N_loc, n_time, rows, ..]
        return v.reshape((N, v.shape[2] * v.shape[3]) + v.shape[4:])
    return fix


def _results(leaves, fix) -> ofdm_sync.FrameResults:
    return ofdm_sync.FrameResults(*(fix(v) for v in leaves))


def make_sharded_mcrx(mesh, num_channels: int, sync: ofdm_sync.OfdmSync,
                      chunk_blocks: int, device=None):
    """Channel- and time-sharded multichannel receiver.

    Each rank calls ``run(x_local)`` with its time chunk of the mixture,
    ``2N * chunk_blocks * block_size`` samples (``run.in_spec =
    ("time",)``: replicated over ``'channel'``); it channelizes the chunk
    and synchronizes its ``N / n_channel_shards`` channels.  Output:
    FrameResults with leaves ``[N, n_time * chunk_blocks * max_frames,
    ...]``, on every rank.
    """
    N = num_channels
    n_time = dim_size(mesh, "time")
    n_ch = dim_size(mesh, "channel")
    if N % n_ch:
        raise ValueError(f"{N} channels not divisible by "
                         f"{n_ch} channel shards")
    N_loc = N // n_ch
    chz = pfb_mod.pfbch_create(2 * N, m=7, As=60.0)
    B = sync.block_size * chunk_blocks          # channel-samples per chunk
    halo = sync.overlap
    if B < halo:
        raise ValueError(
            f"per-device chunk ({B}) must cover the halo ({halo})")
    mix_B = 2 * N * B
    mix_halo = 2 * N * halo
    freq = -_center_offset(N)
    dev = distributed.local_device(device)
    t_idx = mesh.get_local_rank("time")
    c_idx = mesh.get_local_rank("channel")
    h = on(chz.h_pol, dev)
    tables = ofdm_sync.sync_tables(sync, dev)
    fix = _make_regroup(N)

    def run(x_local):
        x = _local_input(x_local, dev, mix_B).reshape(-1)
        left = ppermute(x[mix_B - mix_halo:], mesh, "time", _chain(n_time))
        ext = torch.cat([left, x])               # [mix_halo + mix_B]
        nco0 = nco_mod.nco_init_at(freq, t_idx * mix_B - mix_halo, dev)
        _, mixed = nco_mod.nco_mix_block(nco0, ext, up=True)
        _, X = pfb_mod.pfb_analyze_block(chz, pfb_mod.pfbch_state(chz, dev),
                                         mixed, h)
        chans = X[:, c_idx * N_loc:(c_idx + 1) * N_loc].T  # [N_loc, halo+B]
        states = ofdm_sync.OfdmSyncState(
            tail=chans[:, :halo],
            base=torch.full((N_loc,), _i32(t_idx * B - halo),
                            dtype=torch.int32, device=dev))
        _, res = ofdm_sync.sync_channels_batched(
            sync, states,
            chans[:, halo:].reshape(N_loc, chunk_blocks, sync.block_size),
            tables)
        local = [v.reshape((N_loc, chunk_blocks * sync.max_frames)
                           + v.shape[3:]) for v in res]
        return _results(gather_tree(local, mesh, TIME_CHANNEL), fix)

    run.regroup = fix
    run.in_spec = ("time",)
    return run


class ShardedMcrxState(NamedTuple):
    """What :func:`make_sharded_mcrx_a2a_step` carries from a super-step
    to the next on each rank: the last ``2N * 4P`` samples of its fine
    chunk (the analysis-filter memory; the last fine chunk's reaches the
    first at the next super-step), the last ``overlap`` samples of its
    channels' streams ``[N_loc, overlap]`` (the sync tails; the last time
    row's reach the first), and the global super-step index, which fixes
    the NCO phase and the int32 block base."""
    ana_tail: torch.Tensor
    s_tail: torch.Tensor
    step: int


def _ring(n: int) -> list[tuple[int, int]]:
    """Each index sends to its right neighbour, the last to the first."""
    return [(i, (i + 1) % n) for i in range(n)]


def _a2a_receiver(mesh, num_channels: int, sync: ofdm_sync.OfdmSync,
                  chunk_blocks: int, device):
    """The all-to-all receiver's super-step on this rank, shared by
    :func:`make_sharded_mcrx_a2a` and :func:`make_sharded_mcrx_a2a_step`:
    ``(init_state, (stage_a, stage_a_finish, stage_b), mix_sub)``.
    ``stage_a`` channelizes the rank's fine chunk (complex64 ``[mix_sub]``)
    and launches the all-to-all, ``stage_a_finish`` waits for it and
    swaps the sync halos, ``stage_b`` syncs the rank's channels into
    leaves ``[N_loc, rows, ...]``.  Between one super-step's ``stage_a``
    and its ``stage_a_finish`` the previous super-step's ``stage_b`` may
    run, while the all-to-all is in flight."""
    N = num_channels
    n_time = dim_size(mesh, "time")
    n_ch = dim_size(mesh, "channel")
    if N % n_ch:
        raise ValueError(f"{N} channels not divisible by {n_ch} shards")
    N_loc = N // n_ch
    chz = pfb_mod.pfbch_create(2 * N, m=7, As=60.0)
    B_sub = sync.block_size * chunk_blocks      # channel-samples, fine chunk
    B_grp = B_sub * n_ch                        # channel-samples per time row
    halo = sync.overlap                         # sync overlap (channel-samp)
    ana_halo = 4 * chz.P                        # analysis filter memory
    if B_grp < halo:
        raise ValueError(
            f"time-row chunk ({B_grp}) must cover the sync halo ({halo})")
    if B_sub < ana_halo:
        raise ValueError(
            f"fine chunk ({B_sub} channel-samples) must cover the "
            f"analysis filter memory ({ana_halo}); raise chunk_blocks "
            f"or block_size")
    mix_sub = 2 * N * B_sub
    freq = -_center_offset(N)
    n_dev = n_time * n_ch
    ana_tail_len = 2 * N * ana_halo
    dev = distributed.local_device(device)
    t_idx = mesh.get_local_rank("time")
    c_idx = mesh.get_local_rank("channel")
    flat = t_idx * n_ch + c_idx                 # fine chunk index
    h = on(chz.h_pol, dev)
    tables = ofdm_sync.sync_tables(sync, dev)
    rows = chunk_blocks * n_ch * sync.max_frames

    def init_state() -> ShardedMcrxState:
        """The stream's start: zero filter memory and sync tails."""
        return ShardedMcrxState(ana_tail=iqfmt.czeros(ana_tail_len, dev),
                                s_tail=iqfmt.czeros((N_loc, halo), dev),
                                step=0)

    def stage_a(x_step, ana_tail_prev, gstep):
        """Channelize one super-step and launch its all-to-all.

        The analysis-filter halo comes from the left neighbour in the
        combined (time, channel) order through one ring ``ppermute``: the
        last fine chunk sends ``ana_tail_prev``, its own tail of the
        previous super-step, round to the first, so the stream is
        continuous across super-steps (step 0 passes zeros: the stream
        start)."""
        tail = x_step[mix_sub - ana_tail_len:]
        left = ppermute(tail if flat < n_dev - 1 else ana_tail_prev, mesh,
                        TIME_CHANNEL, _ring(n_dev))
        with span("rx.front_end"):
            ext = torch.cat([left, x_step])
            # NCO at the fine chunk's global index, exact in uint32
            gidx = gstep * n_dev + flat
            nco0 = nco_mod.nco_init_at(freq, gidx * mix_sub - ana_tail_len,
                                       dev)
            _, mixed = nco_mod.nco_mix_block(nco0, ext, up=True)
            _, X = pfb_mod.pfb_analyze_block(
                chz, pfb_mod.pfbch_state(chz, dev), mixed, h)
            chans = X[ana_halo:, :N]             # [B_sub, N] valid frames
        # reshard: channels split over 'channel', fine time gathered: the
        # received pieces stack in c order, the fine chunks of this row
        pending = all_to_all(chans.reshape(B_sub, n_ch, N_loc), mesh,
                             "channel", split_axis=1, concat_axis=0,
                             async_op=True)
        return pending, tail

    def stage_a_finish(pending, sync_tail_prev):
        """The all-to-all's result as per-channel streams ``[N_loc,
        B_grp]`` and their sync halo from the previous time row (row 0's
        comes round the ring from the last row's previous super-step)."""
        streams = pending.wait().reshape(B_grp, N_loc).T
        s_tail = streams[:, B_grp - halo:]
        s_left = ppermute(s_tail if t_idx < n_time - 1 else sync_tail_prev,
                          mesh, "time", _ring(n_time))
        return streams, s_left, s_tail

    def stage_b(streams, s_left, gstep):
        base = _i32((gstep * n_time + t_idx) * B_grp - halo)
        # flat channels-x-blocks candidate batch, one decode gate
        states = ofdm_sync.OfdmSyncState(
            tail=s_left, base=torch.full((N_loc,), base, dtype=torch.int32,
                                         device=dev))
        _, res = ofdm_sync.sync_channels_batched(
            sync, states,
            streams.reshape(N_loc, chunk_blocks * n_ch, sync.block_size),
            tables)
        return [v.reshape((N_loc, rows) + v.shape[3:]) for v in res]

    return init_state, (stage_a, stage_a_finish, stage_b), mix_sub


def make_sharded_mcrx_a2a(mesh, num_channels: int,
                          sync: ofdm_sync.OfdmSync, chunk_blocks: int,
                          ingest: str = "c64", n_steps: int = 1,
                          device=None):
    """All-to-all sharded multichannel receiver (no duplicated channelizer).

    The mixture is split into ``n_time * n_ch`` *fine* time chunks over the
    flattened mesh, so every rank channelizes distinct samples (only a
    filter-memory halo is duplicated); one all-to-all over ``'channel'``
    reshards channelizer output into per-channel streams, a ``ppermute``
    over ``'time'`` provides the synchronizer overlap, and each rank syncs
    its channel subset.  Output like :func:`make_sharded_mcrx` (leaves
    ``[N, rows, ...]``).

    Each rank calls ``run(x_local)`` with its fine chunk of ``mix_sub = 2N
    * chunk_blocks * block_size`` samples (``run.in_spec = (("time",
    "channel"),)``).  ``ingest="bf16"`` takes bfloat16 I/Q planes ``[2,
    mix_sub]`` (the global ``[2, total]``, plane axis whole; see
    ``ops/iqfmt.py``).

    ``n_steps > 1`` takes ``[n_steps, mix_sub]`` (planes ``[n_steps, 2,
    mix_sub]``): a longer stream as a software-pipelined sequence of
    super-steps.  Super-step ``i``'s all-to-all is launched asynchronously
    and super-step ``i-1``'s frame sync runs while it is in flight (the
    overlap JAX leaves to XLA's scheduler).  Filter memory, NCO phase and
    sync overlap carry across super-steps exactly (the wrap-around halos
    ride the ring ``ppermute``\\ s), so the result equals the receiver over
    the whole stream in one shot.
    """
    if ingest not in ("c64", "bf16"):
        raise ValueError(f"unknown ingest {ingest!r} (c64 or bf16)")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1 (got {n_steps})")
    init_state, (stage_a, stage_a_finish, stage_b), mix_sub = \
        _a2a_receiver(mesh, num_channels, sync, chunk_blocks, device)
    N, n_time = num_channels, dim_size(mesh, "time")
    planes = ingest == "bf16"
    dev = distributed.local_device(device)

    def run(x_local):
        n_in = n_steps * mix_sub * (2 if planes else 1)
        x = _local_input(x_local, dev, n_in)
        x = (x.reshape(n_steps, 2, mix_sub) if planes
             else x.reshape(n_steps, mix_sub))
        ana_tail, s_tail, _ = init_state()
        results = []
        prev = None                               # (streams, s_left) of i-1
        for i in range(n_steps):
            pending, ana_tail = stage_a(iqfmt.iq_from_any(x[i]), ana_tail,
                                       i)
            if prev is not None:                 # while the a2a is in flight
                results.append(stage_b(*prev, i - 1))
            streams, s_left, s_tail = stage_a_finish(pending, s_tail)
            prev = (streams, s_left)
        results.append(stage_b(*prev, n_steps - 1))
        local = [torch.stack(leaf) for leaf in zip(*results)]
        return _results(gather_tree(local, mesh, TIME_CHANNEL), fix)

    def fix(v):
        # [n_time, n_ch, n_steps, N_loc, rows, ...] -> [N, total_rows, ...]
        # with global row order (step, time, row)
        v = np.transpose(v, (1, 3, 2, 0) + tuple(range(4, v.ndim)))
        return v.reshape((N, n_steps * n_time * v.shape[4])
                         + v.shape[5:])

    run.regroup = fix
    lead = (None,) * ((n_steps > 1) + planes)
    run.in_spec = lead + (TIME_CHANNEL,)
    return run


def make_sharded_mcrx_a2a_step(mesh, num_channels: int,
                               sync: ofdm_sync.OfdmSync, chunk_blocks: int,
                               device=None):
    """The all-to-all sharded receiver as a streaming step: ``(init_state,
    step)``, as :func:`..models.multichannel.make_mcrx_batched_step`
    gives, for ``io/pipeline.py::run_pipelined`` on every rank.

    Each rank calls ``step(state, x_local)`` with its fine chunk of one
    dispatch, ``2N * chunk_blocks * block_size`` samples (complex64, or IQ
    planes ``[2, ...]``), cut as :func:`make_sharded_mcrx_a2a`'s
    (``step.in_spec``), and gets ``(state', results)``.  The state
    (:class:`ShardedMcrxState`) carries the filter memory, the sync tails
    and the super-step index, so ``k`` calls give the rows of the one-shot
    ``make_sharded_mcrx_a2a(..., n_steps=k)`` over the same stream.  Each
    call finishes its own super-step.  The rank at ``(0, 0)`` gets the
    dispatch's ``FrameResults`` with leaves ``[N, n_time * chunk_blocks *
    n_ch * max_frames, ...]`` in global channel and row order, gathered
    and regrouped on its device (:func:`._comm.gather_first`: under NCCL
    no host copy and no host wait); every other rank gets its own
    channels' ``[N_loc, ...]``.  Spans: ``rx.dispatch`` a call,
    ``rx.front_end`` around the NCO and the analyzer, ``rx.exchange``
    around each collective (``_comm``).
    """
    init_state, (stage_a, stage_a_finish, stage_b), mix_sub = \
        _a2a_receiver(mesh, num_channels, sync, chunk_blocks, device)
    N = num_channels
    dev = distributed.local_device(device)

    def regroup(v):
        # [n_time, n_ch, N_loc, rows, ...] -> [N, n_time * rows, ...]
        return v.movedim(0, 2).reshape((N, -1) + tuple(v.shape[4:]))

    def step(state: ShardedMcrxState, x_local):
        with span("rx.dispatch"):
            x = iqfmt.iq_from_any(torch.as_tensor(x_local, device=dev))
            if x.shape != (mix_sub,):
                raise ValueError(f"this rank's chunk holds {tuple(x.shape)} "
                                 f"samples, the step expects ({mix_sub},) "
                                 f"(see step.in_spec)")
            pending, ana_tail = stage_a(x, state.ana_tail, state.step)
            streams, s_left, s_tail = stage_a_finish(pending, state.s_tail)
            leaves = stage_b(streams, s_left, state.step)
            state = ShardedMcrxState(ana_tail, s_tail, state.step + 1)
            full = gather_first(leaves, mesh, TIME_CHANNEL)
            res = ofdm_sync.FrameResults(*(
                leaves if full is None else map(regroup, full)))
        return state, res

    step.in_spec = (TIME_CHANNEL,)
    return init_state, step


# The all-to-all variant is the DEFAULT sharded multichannel receiver: it
# is the only one whose per-rank channelizer work shrinks as the mesh
# grows (make_sharded_mcrx channelizes the full time chunk on every channel
# shard and is kept as the simpler equivalence oracle).
sharded_mcrx = make_sharded_mcrx_a2a


def make_sharded_mctx(mesh, num_channels: int, chunk_samples: int,
                      device=None):
    """All-to-all sharded multichannel TRANSMITTER — the synthesis dual of
    :func:`make_sharded_mcrx_a2a`.

    Per-channel baseband streams ``[N, T]`` arrive channel-major: rank
    ``(t, c)`` calls ``run(s_local)`` with channel group ``c``'s ``[N_loc,
    n_ch * chunk_samples]`` slab of time row ``t`` (``run.in_spec =
    ("channel", "time")``).  One all-to-all over ``'channel'`` transposes
    it into ``[N, chunk]``, so every rank synthesizes a distinct fine time
    chunk of the mixture.  The polyphase synthesizer's carried state is its
    last ``P-1`` input frames, so a ``ppermute`` halo of ``P-1`` frames from
    the combined-order left neighbour reproduces the sequential filter
    memory exactly; the centering NCO starts at the chunk's global sample
    index.

    ``run`` returns the mixture ``[2N * n_time * n_ch * chunk_samples]`` on
    every rank, equal to the sequential ``make_mctx_step`` loop.
    """
    N = num_channels
    n_time = dim_size(mesh, "time")
    n_ch = dim_size(mesh, "channel")
    if N % n_ch:
        raise ValueError(f"{N} channels not divisible by {n_ch} shards")
    N_loc = N // n_ch
    chz = pfb_mod.pfbch_create(2 * N, m=13, As=60.0)
    halo_f = chz.P - 1                    # synthesis filter memory (frames)
    B_sub = int(chunk_samples)            # channel-samples per fine chunk
    if B_sub < halo_f:
        raise ValueError(
            f"chunk ({B_sub}) must cover the filter memory ({halo_f})")
    freq = _center_offset(N)
    n_dev = n_time * n_ch
    dev = distributed.local_device(device)
    flat = mesh.get_local_rank("time") * n_ch + mesh.get_local_rank(
        "channel")
    h = on(chz.h_pol, dev)

    def run(s_local):
        s = _local_input(s_local, dev, N_loc * n_ch * B_sub).to(
            torch.complex64)
        # channel groups -> fine time chunks: the received groups stack in
        # channel order, all N channels of this rank's fine chunk
        grp = all_to_all(s.reshape(N_loc, n_ch, B_sub), mesh, "channel",
                         split_axis=1, concat_axis=0).reshape(N, B_sub)
        Y = iqfmt.czeros((B_sub, 2 * N), dev)
        Y[:, :N] = grp.T                  # channels ride bins 0..N-1
        # synthesis filter memory: the previous fine chunk's last P-1
        # input frames, over the combined (time, channel) order
        left = ppermute(Y[B_sub - halo_f:], mesh, TIME_CHANNEL,
                        _chain(n_dev))
        ext = torch.cat([left, Y])        # [halo_f + B_sub, 2N]
        _, y_ext = pfb_mod.pfb_synthesize_block(
            chz, pfb_mod.pfbch_state(chz, dev), ext, h)
        y = y_ext[2 * N * halo_f:]        # [2N * B_sub] valid samples
        nco0 = nco_mod.nco_init_at(freq, flat * 2 * N * B_sub, dev)
        _, y = nco_mod.nco_mix_block(nco0, y, up=True)
        (mix,) = gather_tree([y], mesh, TIME_CHANNEL)
        return mix.reshape(-1)

    run.in_spec = ("channel", "time")
    return run
