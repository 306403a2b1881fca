"""Rank functions for the multi-rank tests: each plants a fault on rank 1
and then runs the benchmark's own rank.  A spawned rank imports this module
by name, so the faults are planted in the rank's process."""
import sys
import time
import types

from rxbench import ranks, txgen
from rxbench.entries import mcrx_pipelined


def _on_rank_1(rank, plant, args):
    if rank == 1:
        plant()
    ranks.rank_main(rank, *args)


def _fail_in_window():
    run, calls = mcrx_pipelined.Entry.run, []

    def failing(self, buffers, clock):
        calls.append(1)
        if len(calls) > 1:             # the first call is the warm-up
            raise RuntimeError("planted: rank 1 fails in the window")
        return run(self, buffers, clock)
    mcrx_pipelined.Entry.run = failing


def _hang_in_window():
    run, calls = mcrx_pipelined.Entry.run, []

    def hanging(self, buffers, clock):
        calls.append(1)
        while len(calls) > 1:
            time.sleep(1)
        return run(self, buffers, clock)
    mcrx_pipelined.Entry.run = hanging


def _other_stream():
    make = txgen.make_stream

    def altered(*a, **k):
        s = make(*a, **k)
        s.chunks[0] = s.chunks[0].copy()
        s.chunks[0][0] += 1e-3
        return s
    txgen.make_stream = altered


def _load_jax():
    sys.modules["jax"] = types.ModuleType("jax")


def fails_in_window(rank, *args):
    _on_rank_1(rank, _fail_in_window, args)


def hangs_in_window(rank, *args):
    _on_rank_1(rank, _hang_in_window, args)


def makes_another_stream(rank, *args):
    _on_rank_1(rank, _other_stream, args)


def loads_jax(rank, *args):
    _on_rank_1(rank, _load_jax, args)
