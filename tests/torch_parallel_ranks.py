"""Rank functions of the parallel-layer tests
(``tests/test_torch_parallel*.py``, ``tests/test_torch_sharded_step.py``).

A world spawned by ``liquid_usrp_tpu_torch.parallel.distributed.spawn``
imports the module of its rank function in each child, so these live here,
in a module that pytest does not collect and that imports no JAX.  Each
takes NumPy inputs and returns NumPy results (rank 0 returns the global
results, which every rank holds; the others return what only they know).
"""
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
from liquid_usrp_tpu_torch.ops import iqfmt
from liquid_usrp_tpu_torch.parallel import _comm, distributed, stream
from liquid_usrp_tpu_torch.parallel.mesh import make_sdr_mesh
from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV

CPU = "cpu"
TC = ("time", "channel")


def _raises(fn, *args, **kwargs) -> str:
    """The type and message of what ``fn`` raises ('' when it returns)."""
    try:
        fn(*args, **kwargs)
    except (ValueError, RuntimeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return ""


def _np(res):
    return {f: np.asarray(v) for f, v in zip(res._fields, res)}


# ---------------------------------------------------------------------------
# test_torch_parallel.py: one 4-rank world (2x2 mesh and 1-D time mesh)
# ---------------------------------------------------------------------------

def mesh_and_collectives(rank, X, Y, family):
    """Mesh layout and errors, the collective helpers, builder errors, the
    no-card rule, and the time-sharded syncs of four frame families."""
    out = {"rank": rank}
    m = make_sdr_mesh()
    out["coord"] = tuple(m.get_coordinate())
    out["time_group"] = dist.get_process_group_ranks(m.get_group("time"))
    out["channel_group"] = dist.get_process_group_ranks(
        m.get_group("channel"))
    out["too_many"] = _raises(make_sdr_mesh, n_devices=5)
    out["bad_shape"] = _raises(make_sdr_mesh, axis_shapes=(3, 1))
    sub = make_sdr_mesh(n_devices=2)            # every rank creates it
    c = sub.get_coordinate()
    out["sub_coord"] = None if c is None else tuple(c)
    out["info"] = distributed.local_info()
    out["is_distributed"] = distributed.is_distributed()
    distributed.init()                          # idempotent

    # collectives: this rank's row of X [4, L] (combined order = rank)
    x = torch.as_tensor(X[rank])
    out["pp_time"] = _comm.ppermute(x, m, "time", [(0, 1)]).numpy()
    out["pp_channel"] = _comm.ppermute(x, m, "channel", [(1, 0)]).numpy()
    out["pp_chain"] = _comm.ppermute(
        x, m, TC, [(i, i + 1) for i in range(3)]).numpy()
    out["pp_wrap"] = _comm.ppermute(x, m, TC, [(3, 0)]).numpy()
    y = torch.as_tensor(stream.shard_for(m, Y, (TC,)))      # [3, 2, 5]
    out["a2a_0"] = _comm.all_to_all(y, m, "channel", 1, 0).numpy()
    pend = _comm.all_to_all(y, m, "channel", 1, 2, async_op=True)
    out["a2a_2"] = pend.wait().numpy()
    leaves = [torch.tensor([rank, -rank], dtype=torch.int32),
              torch.tensor([rank % 2 == 0, True]),
              torch.tensor([rank, 255 - rank], dtype=torch.uint8),
              torch.tensor([[0.5 * rank]], dtype=torch.float32),
              x]
    out["gathered"] = _comm.gather_tree(leaves, m, TC)
    out["gathered_time"] = _comm.gather_tree(leaves[:1], m, "time")
    out["shards"] = {
        str(spec): np.asarray(stream.shard_for(m, X, spec))
        for spec in (("time",), (TC,), ("channel", "time"), (None, TC))}

    # builder errors, as JAX raises them, and the no-card rule
    params = ofdm.make_ofdm_params(48, 6, 4)
    sync = ofdm_sync.make_sync(params, block_size=2048, max_payload=64,
                               max_frames=4, use_pallas=0)
    out["err_channels"] = _raises(stream.make_sharded_mcrx, m, 3, sync, 2,
                                  device=CPU)
    out["err_halo"] = _raises(stream.make_sharded_mcrx, m, 4, sync, 1,
                              device=CPU)
    out["err_a2a_channels"] = _raises(stream.make_sharded_mcrx_a2a, m, 3,
                                      sync, 1, device=CPU)
    out["err_time_halo"] = _raises(stream.make_time_sharded_sync, m, sync,
                                   1, device=CPU)
    os.environ.pop(DEVICE_ENV, None)
    out["no_card"] = _raises(stream.make_sharded_mcrx, m, 4, sync, 2)

    # time sharding over a 1-D mesh of the same world
    tm = init_device_mesh("cpu", (4,), mesh_dim_names=("time",))
    for name, sy in family["syncs"].items():
        run = stream.make_time_sharded_sync(tm, sy,
                                            family["chunk_blocks"][name],
                                            device=CPU)
        res = run(stream.shard_for(tm, family["streams"][name],
                                   run.in_spec))
        if rank == 0:
            out[f"time_{name}"] = _np(res)
    return out


# ---------------------------------------------------------------------------
# test_torch_parallel_mcrx.py: one 2x2 world
# ---------------------------------------------------------------------------

def _regroup_probe(n_steps):
    """A gathered leaf ``[n_time, n_ch, (n_steps,) N_loc, rows, 3]`` of a
    2x2 mesh with N=4 whose every element is its own flat index."""
    lead = (2, 2) + ((n_steps,) if n_steps else ()) + (2, 5, 3)
    return np.arange(int(np.prod(lead))).reshape(lead)


def receivers(rank, cfg, mixture, planes, piped, streams):
    """The duplicate-channelizer and all-to-all receivers (c64, bf16
    planes, pipelined super-steps and their one-shot form), the sharded
    transmitter, and TX -> RX through the world."""
    m = make_sdr_mesh()
    params = ofdm.make_ofdm_params(48, 6, 4)
    sync = ofdm_sync.make_sync(params, **cfg["sync"])
    N = cfg["N"]
    out = {}

    def rx(builder, data, *args, **kwargs):
        run = builder(m, N, sync, *args, device=CPU, **kwargs)
        res = run(stream.shard_for(m, data, run.in_spec))
        return _np(res) if rank == 0 else None

    out["mcrx"] = rx(stream.make_sharded_mcrx, mixture, 2)
    out["a2a"] = rx(stream.make_sharded_mcrx_a2a, mixture, 1)
    out["a2a_bf16"] = rx(stream.make_sharded_mcrx_a2a,
                         torch.as_tensor(planes).to(torch.bfloat16), 1,
                         ingest="bf16")
    n_steps = cfg["n_steps"]
    sync1 = ofdm_sync.make_sync(params, **{**cfg["sync"], "use_pallas": 1})
    for name, data, kw in (
            ("piped", piped.reshape(n_steps, -1),
             dict(chunk_blocks=2, n_steps=n_steps)),
            ("one_shot", piped, dict(chunk_blocks=2 * n_steps))):
        run = stream.make_sharded_mcrx_a2a(m, N, sync1, device=CPU, **kw)
        res = run(stream.shard_for(m, data, run.in_spec))
        out[name] = _np(res) if rank == 0 else None
        if name == "piped" and rank == 0:
            out["regroup_piped"] = run.regroup(_regroup_probe(n_steps))
    if rank == 0:
        run = stream.make_sharded_mcrx(m, N, sync, 2, device=CPU)
        out["regroup_mcrx"] = run.regroup(_regroup_probe(None))

    tx = stream.make_sharded_mctx(m, N, cfg["chunk_samples"], device=CPU)
    mix = tx(stream.shard_for(m, streams, tx.in_spec))
    # TX -> RX across the processes (the two-process JAX test's pipeline)
    run = stream.sharded_mcrx(m, N, sync, cfg["tx_rx_chunk_blocks"],
                              device=CPU)
    res = run(stream.shard_for(m, mix, run.in_spec))
    if rank == 0:
        out["mctx"] = mix
        out["tx_rx"] = _np(res)
    return out


# ---------------------------------------------------------------------------
# test_torch_gpu.py: ranks that share the card
# ---------------------------------------------------------------------------

def card_sharded_mcrx(rank, cfg, mixture):
    """``sharded_mcrx`` on a 1x2 mesh on the rank's card (no device asked:
    the card): the results, this rank's kernel launches, its device and the
    backend."""
    from liquid_usrp_tpu_torch.ops import kernels
    m = make_sdr_mesh(axis_shapes=(1, 2))
    sync = ofdm_sync.make_sync(ofdm.make_ofdm_params(48, 6, 4),
                               **cfg["sync"])
    run = stream.sharded_mcrx(m, cfg["N"], sync, cfg["chunk_blocks"])
    kernels.reset_launch_counts()
    res = run(stream.shard_for(m, mixture, run.in_spec))
    return {"res": _np(res), "launches": dict(kernels.launches),
            "device": str(distributed.local_device()),
            "backend": dist.get_backend()}


# ---------------------------------------------------------------------------
# spawn's error paths
# ---------------------------------------------------------------------------

def fails_on_rank_one(rank):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()
    return rank


def hangs(rank):
    """Every rank waits for a rank that never joins the collective."""
    if rank == 0:
        dist.barrier()
    else:
        import time
        time.sleep(3600)


# ---------------------------------------------------------------------------
# test_torch_sharded_step.py: one 2x2 world, and planted faults in the
# benchmark's ranks
# ---------------------------------------------------------------------------

def _traced(step, state, x):
    """One ``step`` call under a CPU profiler: ``(state', results, trace,
    exchange_bytes added)``, the trace as the benchmark collects it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from liquid_usrp_tpu_torch.utils import profiling
    from rxbench import profiling as rxprof
    before = profiling.counters.get("exchange_bytes", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(rxprof.WINDOW):
            state, res = step(state, x)
    sent = profiling.counters.get("exchange_bytes", 0) - before
    return state, res, rxprof.collect(prof, 1), sent


def sharded_step(rank, cfg, dispatches):
    """``make_sharded_mcrx_a2a_step`` over ``dispatches`` (global mixture
    chunks; its last call traced: its spans, the bytes it counted and what
    the benchmark's readers read of it), over the first two as bfloat16
    planes, and the one-shot ``n_steps`` form over the same stream."""
    from rxbench import spans
    from rxbench.metrics import (exchange_host_ms, exchange_mbytes,
                                 exchange_roofline_pct)
    m = make_sdr_mesh()
    sync = ofdm_sync.make_sync(ofdm.make_ofdm_params(48, 6, 4),
                               **cfg["sync"])
    N, k = cfg["N"], len(dispatches)
    init, step = stream.make_sharded_mcrx_a2a_step(m, N, sync, 1,
                                                   device=CPU)
    mine = [stream.shard_for(m, d, step.in_spec) for d in dispatches]
    out = {"in_spec": step.in_spec,
           "bad_chunk": _raises(step, init(), mine[0][:-1])}

    state, res = init(), []
    for x in mine[:-1]:
        state, r = step(state, x)
        res.append(r)
    state, r, trace, sent = _traced(step, state, mine[-1])
    res.append(r)
    out["shapes"] = [tuple(r.payload.shape) for r in res]
    out["on_device"] = all(isinstance(v, torch.Tensor) and v.device.type ==
                           CPU for r in res for v in r)
    out["state_step"] = state.step
    out["spans"] = {n: len(spans.spans(trace, n)) for n in
                    ("rx.exchange", "rx.dispatch", "rx.front_end")}
    out["exchange_bytes"] = sent
    out["local_bytes"] = sum(v.numel() * v.element_size() for v in r)
    cell = {"config": {"num_channels": N, "mesh": [2, 2]}}
    out["readers"] = {
        "exchange_host_ms": exchange_host_ms.read(trace, cell),
        "exchange_mbytes": exchange_mbytes.read(trace, cell),
        "exchange_roofline_pct": exchange_roofline_pct.read(trace, cell)}

    state, planes = init(), []
    for x in mine[:2]:
        state, r = step(state, iqfmt.iq_to_planes(torch.as_tensor(x)))
        planes.append(r)
    run = stream.make_sharded_mcrx_a2a(m, N, sync, 1, n_steps=k, device=CPU)
    one_shot = run(stream.shard_for(m, np.stack(dispatches), run.in_spec))
    if rank == 0:
        out["step"] = [_np(r) for r in res]
        out["step_bf16"] = [_np(r) for r in planes]
        out["one_shot"] = _np(one_shot)
    return out


def _reinit_state():
    """Every call of the sharded step starts from a fresh state."""
    from rxbench.entries import mcrx_sharded
    build = mcrx_sharded.make_sharded_mcrx_a2a_step

    def planted(*args, **kwargs):
        init, step = build(*args, **kwargs)

        def fresh(state, x):
            return step(init(), x)
        fresh.in_spec = step.in_spec
        return init, fresh
    mcrx_sharded.make_sharded_mcrx_a2a_step = planted


def _own_rows_only():
    """Rank 0's gathered results keep only its own rows."""
    gather = stream.gather_first

    def own(leaves, mesh, dims):
        full = gather(leaves, mesh, dims)
        for v in full or ():
            mine = v[0, 0].clone()
            v.zero_()
            v[0, 0] = mine
        return full
    stream.gather_first = own


def reinits_state(rank, *args):
    from rxbench import ranks
    _reinit_state()
    ranks.rank_main(rank, *args)


def reports_own_rows(rank, *args):
    from rxbench import ranks
    _own_rows_only()
    ranks.rank_main(rank, *args)
