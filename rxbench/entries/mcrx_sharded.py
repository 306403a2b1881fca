"""The multichannel receiver sharded over the cards of one host:
``io/pipeline.py::run_pipelined`` driving the all-to-all sharded step
(``parallel/stream.py::make_sharded_mcrx_a2a_step``) on every rank.

One rank a card (``rxbench/ranks.py``).  The mesh is the port's
``make_sdr_mesh`` over the world the harness formed, shaped as the
configuration's ``mesh`` (time x channel).  Each rank's host buffers are
its own fine chunk of every dispatch, cut by the program's ``shard_for``
with the step's ``in_spec``, as each host would read its share from its
own file or radio.  Rank 0 gets each dispatch's global results on its
card and the benchmark's sink brings them to the host in one copy; every
rank reads its clock as its ``on_results`` is called.

On the cards each rank binds itself, every thread it has and every thread
it will start, to its own ``1/k`` of the host's cores, and runs two fewer
intra-op threads than it has cores, leaving room for its prefetch and
collective threads: the host-bound decode of four lock-stepped ranks is
otherwise slowed by whichever rank's threads the scheduler moves.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
from liquid_usrp_tpu_torch.io.pipeline import run_pipelined
from liquid_usrp_tpu_torch.parallel.mesh import make_sdr_mesh
from liquid_usrp_tpu_torch.parallel.stream import (make_sharded_mcrx_a2a_step,
                                                   shard_for)

from ..sink import frame_rows, to_host


def own_cores(rank: int, k: int, cores) -> list:
    """Rank ``rank``'s share of ``cores`` among ``k`` ranks: the
    ``rank``-th of ``k`` equal runs of them in order (empty where there
    are fewer cores than ranks)."""
    cores = sorted(cores)
    n = len(cores) // k
    return cores[rank * n:(rank + 1) * n]


def pin_to_own_cores() -> list:
    """Bind this rank's threads to :func:`own_cores` and set its intra-op
    threads to two fewer than those cores (at least one); returns them."""
    mine = own_cores(dist.get_rank(), dist.get_world_size(),
                     os.sched_getaffinity(0))
    if not mine:
        return mine
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), mine)
        except (ProcessLookupError, PermissionError):
            pass                  # a thread that ended meanwhile
    torch.set_num_threads(max(1, len(mine) - 2))
    return mine


class Entry:
    def __init__(self, config: dict, device, ingest: str = "c64"):
        if torch.device(device).type == "cuda" and dist.is_initialized() \
                and dist.get_world_size() > 1:
            pin_to_own_cores()
        N = config["num_channels"]
        params = ofdm.make_ofdm_params(config["M"], config["cp_len"],
                                       config["taper_len"])
        sync = ofdm_sync.make_sync(
            params, block_size=config["block_size"],
            max_payload=config["max_payload"],
            max_frames=config["max_frames"],
            expansion=config["expansion"],
            use_pallas=config["use_pallas"])
        n_time, n_ch = config["mesh"]
        self._mesh = make_sdr_mesh(axis_shapes=(n_time, n_ch))
        self._init, self._step = make_sharded_mcrx_a2a_step(
            self._mesh, N, sync, config["chunk_blocks"], device)
        self.blocks_per_dispatch = config["chunk_blocks"] * n_time * n_ch
        if self.blocks_per_dispatch != config["n_blocks"]:
            raise ValueError(f"n_blocks {config['n_blocks']} is not "
                             f"chunk_blocks x the mesh's ranks "
                             f"({self.blocks_per_dispatch})")
        self.dispatch_samples = 2 * N * config["block_size"] * \
            self.blocks_per_dispatch
        self.ingest = ingest
        self._root = tuple(self._mesh.get_coordinate()) == (0, 0)
        self._rows: list = []

    def host_input(self, chunk: np.ndarray):
        """This rank's fine chunk of ``chunk``: complex64 as it is;
        ``"bf16"``: host bfloat16 planes ``[2, n]``."""
        mine = shard_for(self._mesh, chunk, self._step.in_spec)
        if self.ingest == "c64":
            return mine
        t = torch.from_numpy(mine)
        return torch.stack([t.real, t.imag]).to(torch.bfloat16)

    def reset(self):
        self._rows = []

    def run(self, buffers, clock):
        def step(state, x):
            clock.called()
            return self._step(state, x)

        def on_results(res):
            if self._root:
                self._rows.append(to_host(res))
            clock.done()

        run_pipelined(buffers, step, self._init(), on_results=on_results)

    def rows(self) -> dict:
        return frame_rows(self._rows)
